"""BASELINE config 5: multi-device 4K wavefront render over a device mesh.

On a multi-GPU host this runs as-is; on a single-device or CPU host, pass
--virtual N to simulate N devices (CPU mesh) and validate the sharding
logic. One JSON line."""

from __future__ import annotations

import argparse
import json
import os
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=3840)
    p.add_argument("--height", type=int, default=2160)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--virtual", type=int, default=0,
                   help="force N virtual CPU devices")
    a = p.parse_args()

    import jax

    if a.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={a.virtual}"
        )
        jax.config.update("jax_platforms", "cpu")

    from sfvp_tpu import RenderConfig, load_obj
    from sfvp_tpu.dist import DistRenderer

    n = len(jax.devices())
    height = a.height - (a.height % n)  # rows divisible by device count
    cfg = RenderConfig(width=a.width, height=height, spp_per_step=a.spp,
                       max_depth=a.depth)
    r = DistRenderer(cfg, load_obj())
    r.step(1)
    import jax as _j

    _j.block_until_ready(r.state.accum)
    m0 = float(r.state.mrays)
    t0 = time.perf_counter()
    r.step(1)
    _j.block_until_ready(r.state.accum)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": f"multichip_{a.width}x{height}_{n}dev",
        "value": round((float(r.state.mrays) - m0) / dt, 2),
        "unit": "Mrays/s",
        "devices": n,
        "step_seconds": round(dt, 2),
    }))


if __name__ == "__main__":
    main()
