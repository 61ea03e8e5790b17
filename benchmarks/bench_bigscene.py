"""BASELINE config 4: 100k+ triangle scene — BVH build time plus BVH
traversal throughput (full GI). One JSON line."""

from __future__ import annotations

import argparse
import json
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tris", type=int, default=100_000)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--scene", choices=["sphere", "city"], default="sphere")
    a = p.parse_args()

    import numpy as np
    import jax

    from sfvp_tpu import RenderConfig, init_state, upload
    from sfvp_tpu.config import CameraConfig
    from sfvp_tpu.dispatch import select_render_step
    from sfvp_tpu.scene.procedural import city_mesh, sphere_mesh
    from sfvp_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if a.scene == "city":
        sub = 9
        scene = city_mesh(n_buildings=max(4, a.tris // (12 * sub * sub)),
                          subdiv=sub)
        cam = CameraConfig.look_at(origin=(13, 9, 13), target=(0, 0.8, 0),
                                   fov_y_deg=55)
    else:
        n = max(32, int(np.sqrt(a.tris / 2)))
        scene = sphere_mesh(n_lat=n, n_lon=n, bump=0.3)
        cam = CameraConfig.look_at(origin=(0, 0, 4), target=(0, 0, 0),
                                   fov_y_deg=50)
    buffers = upload(scene)
    cfg = RenderConfig(
        width=a.size, height=a.size, spp_per_step=a.spp, max_depth=a.depth,
        camera=cam, sampling="cosine", sky_emission=(0.8, 0.85, 1.0),
    )
    # dispatch builds the BVH and picks the jnp BVH traversal; the build
    # is set-up time
    t0 = time.perf_counter()
    step = jax.jit(select_render_step(cfg, buffers), donate_argnums=(0,))
    build_s = time.perf_counter() - t0
    state = init_state(cfg.height, cfg.width)
    state = step(state)
    jax.block_until_ready(state.accum)
    m0 = float(state.mrays)
    t0 = time.perf_counter()
    state = step(state)
    jax.block_until_ready(state.accum)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": f"bigscene_{a.scene}_{scene.num_triangles}tris_{a.size}px_gi",
        "value": round((float(state.mrays) - m0) / dt, 2),
        "unit": "Mrays/s",
        "setup_seconds": round(build_s, 2),
        "step_seconds": round(dt, 2),
    }))


if __name__ == "__main__":
    main()
