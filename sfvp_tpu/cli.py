"""Command-line entry point — the analog of the reference's ``main()``
(ref main.cpp:457-690), with every hardcoded constant exposed as a flag
(defaults = reference values).

Example:
    python -m sfvp_tpu.cli --steps 32 --out cornell.png
"""

from __future__ import annotations

import argparse
import dataclasses

from .config import CameraConfig, RenderConfig
from .render.driver import Renderer
from .scene import cornell_box_path, load_obj


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sfvp", description=__doc__)
    p.add_argument("--obj", default=None, help="OBJ scene path (default: bundled Cornell Box)")
    p.add_argument("--scene",
                   choices=["cornell", "sphere", "terrain", "city",
                            "instanced"],
                   default="cornell",
                   help="procedural test scene when --obj is not given "
                        "(instanced = shared-mesh spheres, flattened)")
    p.add_argument("--scene-tris", type=int, default=100_000,
                   help="approximate triangle count for procedural scenes")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--steps", type=int, default=32, help="progressive steps to run")
    p.add_argument("--spp", type=int, default=32, help="samples per step")
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--spp-chunk", type=int, default=1)
    p.add_argument("--sampling", choices=["uniform", "cosine"], default="uniform")
    p.add_argument("--rr", action="store_true", help="enable Russian roulette")
    p.add_argument("--nee", action="store_true", help="enable next-event estimation")
    p.add_argument("--mis", action="store_true",
                   help="balance-heuristic MIS between NEE and BSDF sampling (implies --nee)")
    p.add_argument("--traversal", choices=["auto", "brute", "bvh"], default="auto")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"],
                   default="auto",
                   help="pallas = the fused Cornell kernel (GPU only; "
                        "raises where it cannot render the config)")
    p.add_argument("--out", default="render.png")
    p.add_argument("--srgb", action="store_true", help="sRGB-encode the PNG (default: unorm clamp like the reference swapchain)")
    p.add_argument("--frame-every", type=int, default=0, help="write intermediate PNG every N steps")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log", default=None, help="JSONL metrics sink")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--preview-port", type=int, default=None,
                   help="serve a live-updating preview at this HTTP port")
    p.add_argument("--devices", action="store_true",
                   help="print the device capability report and exit")
    p.add_argument("--env-map", default=None,
                   help="equirectangular sky image (PNG/PPM/Radiance .hdr) "
                        "for image-based lighting")
    p.add_argument("--lens-radius", type=float, default=0.0,
                   help="thin-lens aperture radius (0 = pinhole)")
    p.add_argument("--focus-dist", type=float, default=0.0,
                   help="focal distance along the view ray")
    p.add_argument("--dist", action="store_true",
                   help="shard the framebuffer by rows over ALL local "
                        "devices (pixel-identical to one device)")
    p.add_argument("--adaptive", type=float, default=None, metavar="FRAC",
                   help="variance-driven adaptive sampling: after warmup, "
                        "each step renders only the noisiest FRAC of tiles")
    p.add_argument("--adaptive-tile", type=int, default=16)
    p.add_argument("--adaptive-warmup", type=int, default=2)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.devices:
        from .utils.diagnostics import print_report

        print_report()
        return 0
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        spp_per_step=args.spp,
        max_depth=args.max_depth,
        spp_chunk=args.spp_chunk,
        sampling=args.sampling,
        use_rr=args.rr,
        use_nee=args.nee or args.mis,
        use_mis=args.mis,
        traversal=args.traversal,
        backend=args.backend,
        camera=CameraConfig(),
    )
    if args.obj:
        scene = load_obj(args.obj)
    elif args.scene == "cornell":
        scene = load_obj(cornell_box_path())
    else:
        import math

        from .scene.procedural import city_mesh, sphere_mesh, terrain_mesh

        if args.scene == "sphere":
            n = max(16, int(math.sqrt(args.scene_tris / 2)))
            scene = sphere_mesh(n_lat=n, n_lon=n, bump=0.3)
        elif args.scene == "instanced":
            from .scene.procedural import instanced_field

            scene = instanced_field(n_tris=args.scene_tris)
        elif args.scene == "city":
            # ~12 subdivided faces per building; solve for the count
            sub = 9
            nb = max(4, args.scene_tris // (12 * sub * sub))
            scene = city_mesh(n_buildings=nb, subdiv=sub)
        else:
            n = max(16, int(math.sqrt(args.scene_tris / 2)) + 1)
            scene = terrain_mesh(n=n)
        if cfg.camera == CameraConfig():
            # reference camera doesn't frame procedural scenes; use a
            # sensible default view (procedural scenes are y-up)
            if args.scene == "city":
                cam = CameraConfig.look_at(
                    origin=(13.0, 9.0, 13.0), target=(0.0, 0.8, 0.0),
                    fov_y_deg=55.0,
                )
            elif args.scene == "instanced":
                cam = CameraConfig.look_at(
                    origin=(10.5, 7.5, 10.5), target=(0.0, 0.6, 0.0),
                    fov_y_deg=50.0,
                )
            else:
                cam = CameraConfig.look_at(
                    origin=(0.0, 2.2, 5.0), target=(0.0, 0.0, 0.0),
                    fov_y_deg=50.0,
                )
            cfg = dataclasses.replace(
                cfg, camera=cam, sky_emission=(0.8, 0.85, 1.0),
            )
    instanced = isinstance(scene, list)
    if instanced and args.env_map:
        raise ValueError(
            "--scene instanced is not combinable with --env-map (set "
            "env_map on a member Scene or flatten the instances)"
        )
    if args.env_map:
        scene.env_map = args.env_map
    if args.lens_radius > 0:
        # applied AFTER scene-specific camera selection so procedural
        # framing keeps working with an open lens
        focus = args.focus_dist
        if focus <= 0.0:
            # an open lens with the focal plane at distance 0 aims every
            # ray at its own origin — never useful; default to the
            # camera-to-center distance (the look-at target plane)
            import math

            focus = math.dist(cfg.camera.origin, cfg.camera.center)
            print(
                f"--lens-radius given without --focus-dist; focusing at "
                f"the camera target plane ({focus:.3g})",
                flush=True,
            )
        cfg = dataclasses.replace(
            cfg,
            camera=dataclasses.replace(
                cfg.camera,
                lens_radius=args.lens_radius,
                focus_dist=focus,
            ),
        )
    if args.dist:
        from .dist import DistRenderer

        r = DistRenderer(cfg, scene)
        if args.resume and args.checkpoint:
            r.resume(args.checkpoint)
        r.run(
            steps=args.steps,
            out=args.out,
            frame_every=args.frame_every,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            log_path=args.log,
            srgb=args.srgb,
            progress=not args.quiet,
            preview_port=args.preview_port,
        )
        return 0
    if args.adaptive is not None:
        from .integrate.adaptive import AdaptiveRenderer

        r = AdaptiveRenderer(
            cfg, scene, frac=args.adaptive, tile=args.adaptive_tile,
            warmup=args.adaptive_warmup,
        )
        if args.resume and args.checkpoint:
            r.resume(args.checkpoint)
        r.run(steps=args.steps, out=args.out, srgb=args.srgb,
              progress=not args.quiet,
              checkpoint_path=args.checkpoint,
              checkpoint_every=args.checkpoint_every)
        return 0
    r = Renderer(cfg, scene)
    if args.resume and args.checkpoint:
        r.resume(args.checkpoint)
    r.run(
        steps=args.steps,
        out=args.out,
        frame_every=args.frame_every,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        log_path=args.log,
        srgb=args.srgb,
        progress=not args.quiet,
        preview_port=args.preview_port,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
