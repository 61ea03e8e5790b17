"""Render the docs gallery: one image per flagship capability.

    python -u tools/gallery.py [--size 384] [--out docs/gallery]

Sequential renders in one process (a JAX process reserves most of a
GPU's memory, so only one may hold the card); each entry prints a
one-line JSON record with its wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=384)
    p.add_argument("--out", default="docs/gallery")
    p.add_argument("--steps", type=int, default=16)
    a = p.parse_args()
    os.makedirs(a.out, exist_ok=True)

    import numpy as np

    from sfvp_tpu import RenderConfig, Renderer, load_obj
    from sfvp_tpu.config import CameraConfig
    from sfvp_tpu.scene.objload import Scene
    from sfvp_tpu.scene.procedural import city_mesh, sphere_mesh
    from sfvp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    s = a.size

    def run(name, cfg, scene, srgb=True, steps=None):
        t0 = time.perf_counter()
        r = Renderer(cfg, scene)
        path = os.path.join(a.out, name + ".png")
        r.run(steps=steps or a.steps, out=path, srgb=srgb, progress=False)
        print(json.dumps({
            "image": path, "wall_s": round(time.perf_counter() - t0, 1),
            "spp": (steps or a.steps) * cfg.spp_per_step,
        }), flush=True)

    # 1. parity Cornell (the reference's exact semantics)
    run("cornell_parity",
        RenderConfig(width=s, height=s, spp_per_step=32, max_depth=8),
        load_obj(), srgb=False)

    # 2. Cornell with every variance-reduction extension on
    run("cornell_nee_mis",
        RenderConfig(width=s, height=s, spp_per_step=32, max_depth=8,
                     sampling="cosine", use_nee=True, use_mis=True,
                     use_rr=True),
        load_obj())

    # 3. 100k-tri displaced sphere, BVH traversal
    cam = CameraConfig.look_at(origin=(0, 0, 4), target=(0, 0, 0),
                               fov_y_deg=50)
    run("sphere_100k",
        RenderConfig(width=s, height=s, spp_per_step=16, max_depth=4,
                     camera=cam, sampling="cosine",
                     sky_emission=(0.8, 0.85, 1.0)),
        sphere_mesh(n_lat=224, n_lon=224, bump=0.3))

    # 4. procedural city with emissive rooftops (NEE + MIS)
    cam = CameraConfig.look_at(origin=(13, 9, 13), target=(0, 0.8, 0),
                               fov_y_deg=55)
    run("city",
        RenderConfig(width=s, height=s, spp_per_step=16, max_depth=4,
                     camera=cam, sampling="cosine", use_nee=True,
                     use_mis=True, sky_emission=(0.25, 0.3, 0.42)),
        city_mesh(n_buildings=96, subdiv=9))

    # 4b. night city, 648 emissive rooftops (many-light NEE)
    cam = CameraConfig.look_at(origin=(13, 9, 13), target=(0, 0.8, 0),
                               fov_y_deg=55)
    run("city_night_648lights",
        RenderConfig(width=s, height=s, spp_per_step=16, max_depth=4,
                     camera=cam, sampling="cosine", use_nee=True,
                     use_rr=True, sky_emission=(0.02, 0.03, 0.06)),
        city_mesh(n_buildings=96, subdiv=9, glossy_ground=True,
                  emissive_frac=0.03))

    # 4c. dense night city, ~2160 emissive rooftops
    cam = CameraConfig.look_at(origin=(13, 9, 13), target=(0, 0.8, 0),
                               fov_y_deg=55)
    run("city_night_2160lights",
        RenderConfig(width=s, height=s, spp_per_step=16, max_depth=4,
                     camera=cam, sampling="cosine", use_nee=True,
                     use_rr=True, sky_emission=(0.02, 0.03, 0.06)),
        city_mesh(n_buildings=96, subdiv=9, glossy_ground=True,
                  emissive_frac=0.10))

    # 5. GGX glossy floor under an area light (MIS)
    big = 6.0
    tris = [
        [[-big, 0, -big], [big, 0, -big], [big, 0, big]],
        [[-big, 0, -big], [big, 0, big], [-big, 0, big]],
        [[-0.6, 2.2, -0.6], [0.6, 2.2, -0.6], [0.6, 2.2, 0.6]],
        [[-0.6, 2.2, -0.6], [0.6, 2.2, 0.6], [-0.6, 2.2, 0.6]],
        [[-1.5, 0, -1.0], [-0.5, 0, -1.0], [-0.5, 1.2, -1.0]],
        [[-1.5, 0, -1.0], [-0.5, 1.2, -1.0], [-1.5, 1.2, -1.0]],
    ]
    glossy = Scene(
        vertices=np.asarray(tris, np.float32).reshape(-1, 3),
        indices=np.arange(18, dtype=np.uint32),
        face_diffuse=np.asarray(
            [[0, 0, 0]] * 4 + [[0.7, 0.1, 0.1]] * 2, np.float32),
        face_emission=np.asarray(
            [[0, 0, 0]] * 2 + [[10, 9, 7]] * 2 + [[0, 0, 0]] * 2,
            np.float32),
        face_specular=np.asarray(
            [[0.85, 0.85, 0.9]] * 2 + [[0, 0, 0]] * 4, np.float32),
        face_mat_type=np.asarray([2, 2, 0, 0, 0, 0], np.int32),
        face_rough=np.asarray([0.15, 0.15, 0, 0, 0, 0], np.float32),
    )
    cam = CameraConfig.look_at(origin=(0.0, 1.6, 4.5), target=(0, 0.5, 0),
                               fov_y_deg=45)
    run("ggx_floor",
        RenderConfig(width=s, height=s, spp_per_step=32, max_depth=4,
                     camera=cam, sampling="cosine", use_nee=True,
                     use_mis=True, sky_emission=(0.05, 0.06, 0.08)),
        glossy)

    # 6. thin-lens depth of field over the city
    import dataclasses

    cam = dataclasses.replace(
        CameraConfig.look_at(origin=(13, 9, 13), target=(0, 0.8, 0),
                             fov_y_deg=55),
        lens_radius=1.0, focus_dist=20.0,
    )
    run("city_dof",
        RenderConfig(width=s, height=s, spp_per_step=16, max_depth=4,
                     camera=cam, sampling="cosine",
                     sky_emission=(0.8, 0.85, 1.0)),
        city_mesh(n_buildings=96, subdiv=9))

    # 7. environment-map IBL with importance-sampled NEE (sunset sphere)
    env_path = os.path.join(a.out, "_sunset_env.png")
    if not os.path.exists(env_path):
        from sfvp_tpu.render.png import encode_png

        hh, ww = 64, 128
        yy = np.linspace(0, 1, hh)[:, None, None]
        xx = np.linspace(0, 2 * np.pi, ww)[None, :, None]
        t = np.clip((yy - 0.35) / 0.15, 0, 1)
        im = (np.array([60, 90, 200.0]) * (1 - t)
              + np.array([255, 160, 70.0]) * t)
        im = np.where(yy > 0.5, np.array([40, 35, 30.0]) + 0 * xx, im)
        d2 = ((yy - 0.45) * 3) ** 2 + ((xx - np.pi * 0.5) * 0.5) ** 2
        im = np.minimum(im + 255 * np.exp(-d2 * 120), 255)
        with open(env_path, "wb") as f:
            f.write(encode_png(im.astype(np.uint8)))
    ibl = sphere_mesh(n_lat=224, n_lon=224, bump=0.3)
    ibl.env_map = env_path
    cam = CameraConfig.look_at(origin=(0, 0.8, 3.6), target=(0, 0, 0),
                               fov_y_deg=50)
    run("sphere_ibl",
        RenderConfig(width=s, height=s, spp_per_step=16, max_depth=4,
                     camera=cam, sampling="cosine", use_nee=True,
                     use_mis=True),
        ibl)

    # 7b. combined area+env NEE: emissive lamp AND the sunset sky both
    # light-sampled per bounce (late round 3)
    lamp = sphere_mesh(n_lat=96, n_lon=96, bump=0.25)
    lv = np.asarray([
        [[-0.5, 1.7, -0.5], [0.5, 1.7, -0.5], [0.5, 1.7, 0.5]],
        [[-0.5, 1.7, -0.5], [0.5, 1.7, 0.5], [-0.5, 1.7, 0.5]],
    ], np.float32).reshape(-1, 3)
    n0 = len(lamp.vertices)
    lamp.vertices = np.concatenate([lamp.vertices, lv])
    lamp.indices = np.concatenate(
        [lamp.indices, (n0 + np.arange(6)).astype(np.uint32)])
    lamp.face_diffuse = np.concatenate(
        [lamp.face_diffuse, np.zeros((2, 3), np.float32)])
    lamp.face_emission = np.concatenate(
        [lamp.face_emission, np.full((2, 3), 14.0, np.float32)])
    lamp.face_specular = np.concatenate(
        [lamp.face_specular, np.zeros((2, 3), np.float32)])
    lamp.face_mat_type = np.concatenate(
        [lamp.face_mat_type, np.zeros((2,), np.int32)])
    lamp.face_material_id = None
    lamp.env_map = env_path
    cam = CameraConfig.look_at(origin=(0, 0.9, 3.8), target=(0, 0.2, 0),
                               fov_y_deg=50)
    run("sphere_lamp_env_nee",
        RenderConfig(width=s, height=s, spp_per_step=16, max_depth=4,
                     camera=cam, sampling="cosine", use_nee=True,
                     use_mis=True),
        lamp)

    # 8. map_Kd texture at scale: 100k tris
    tex_path = os.path.join(a.out, "_checker_tex.png")
    if not os.path.exists(tex_path):
        from sfvp_tpu.render.png import encode_png

        yy, xx = np.mgrid[0:64, 0:64]
        cells = ((xx // 8 + yy // 8) % 2).astype(np.uint8)
        im = np.where(cells[..., None] > 0, [235, 235, 235],
                      [200, 40, 40]).astype(np.uint8)
        with open(tex_path, "wb") as f:
            f.write(encode_png(im))
    tex = sphere_mesh(n_lat=224, n_lon=224, bump=0.3)
    t = len(tex.face_diffuse)
    tri = tex.vertices[tex.indices.reshape(-1)].reshape(t, 3, 3)
    tex.face_uv = np.stack(
        [tri[..., 0] * 0.5 + 0.5, tri[..., 2] * 0.5 + 0.5], axis=-1
    ).astype(np.float32)
    tex.face_tex = np.zeros((t,), np.int32)
    tex.texture_paths = [tex_path]
    cam = CameraConfig.look_at(origin=(0, 2.2, 5.0), target=(0, 0, 0),
                               fov_y_deg=50)
    run("sphere_textured",
        RenderConfig(width=s, height=s, spp_per_step=16, max_depth=4,
                     camera=cam, sampling="cosine",
                     sky_emission=(0.8, 0.85, 1.0)),
        tex)

    # 9. instanced TLAS: 50 instances sharing two displaced-sphere BLASes
    # over a ground slab (ref TLAS-over-1-BLAS, main.cpp:521-538,
    # generalized to real instancing; flattened for tracing). An instance list
    # is a first-class Renderer scene (dispatch.select_instanced_render_
    # step), so this rides the normal run() helper.
    from sfvp_tpu.scene.procedural import instanced_field

    run("instanced_tlas",
        RenderConfig(width=s, height=s, spp_per_step=16, max_depth=4,
                     camera=CameraConfig.look_at(origin=(10.5, 7.5, 10.5),
                                                 target=(0, 0.6, 0),
                                                 fov_y_deg=50),
                     sampling="cosine", sky_emission=(0.8, 0.85, 1.0)),
        instanced_field(n_tris=220_000, n_inst=49))


if __name__ == "__main__":
    main()
