"""Backend dispatch: choose the integrator and trace implementation from
the config, the scene and the platform. The reference has one hardware
path (traceRayEXT); this renderer has software paths with the same
estimator and the same sample streams:

  - brute/pallas: the fused Cornell kernel (kernels/megakernel.py), one
                  launch per step; GPU only, and only for configs inside
                  its capability set (megakernel.unsupported)
  - brute/jnp:    the wavefront integrator with a scan over triangles
  - bvh/jnp:      the wavefront integrator with the stackless BVH
                  traversal (kernels/bvh_traverse.py)
  - instanced:    lists of Instances are flattened into world-space
                  triangles and dispatched like any other scene

``backend="auto"`` takes the fused kernel whenever it can render the
config and the jnp integrator otherwise. An explicit ``"pallas"`` that
the kernel cannot honour raises; it never falls back silently.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import jax

from .config import RenderConfig
from .kernels.intersect import trace_brute_jnp


def _dbg(choice: str, **why) -> None:
    """SFVP_DISPATCH_DEBUG=1 prints which integrator a config routed to
    and why (stderr, one line per selection)."""
    import os

    if os.environ.get("SFVP_DISPATCH_DEBUG", "") not in ("", "0"):
        import sys

        detail = " ".join(f"{k}={v}" for k, v in why.items())
        print(f"[sfvp dispatch] {choice} {detail}".rstrip(),
              file=sys.stderr, flush=True)


def _traversal(cfg: RenderConfig, buffers) -> str:
    if cfg.traversal != "auto":
        return cfg.traversal
    return "brute" if buffers.num_tris <= cfg.brute_force_max_tris else "bvh"


def kernel_blockers(cfg: RenderConfig, buffers) -> List[str]:
    """Why the fused Cornell kernel cannot render (cfg, scene) here;
    empty when it can."""
    from .kernels.megakernel import unsupported

    out = []
    platform = jax.default_backend()
    if platform != "gpu":
        out.append(f"platform {platform!r} (the kernel compiles for GPUs)")
    if _traversal(cfg, buffers) != "brute":
        out.append("BVH traversal")
    return out + unsupported(cfg, buffers)


def _resolve(cfg: RenderConfig, buffers):
    """(backend, traversal) with "auto" resolved; raises when an explicit
    backend="pallas" cannot be honoured."""
    traversal = _traversal(cfg, buffers)
    if cfg.backend == "jnp":
        return "jnp", traversal
    if cfg.backend not in ("auto", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    blockers = kernel_blockers(cfg, buffers)
    if cfg.backend == "pallas" and blockers:
        raise ValueError(
            "backend='pallas' (the fused Cornell kernel) cannot render this "
            "config: " + "; ".join(blockers)
            + ". Use backend='auto' or 'jnp'."
        )
    return ("jnp" if blockers else "pallas"), traversal


def select_trace_fn(cfg: RenderConfig, buffers) -> Callable:
    """Trace-function-level dispatch (used by the jnp integrator)."""
    if _traversal(cfg, buffers) == "brute":
        return trace_brute_jnp
    from .accel import build_bvh
    from .kernels.bvh_traverse import make_trace_bvh_jnp

    bvh = build_bvh(buffers, leaf_size=cfg.bvh_leaf_size)
    return make_trace_bvh_jnp(bvh)


def select_render_step(
    cfg: RenderConfig,
    buffers,
    global_shape: Optional[tuple] = None,
    trace_fn: Optional[Callable] = None,
) -> Callable:
    """Integrator-level dispatch: returns render_step(state, row0) -> state.

    An explicit trace_fn pins the jnp integrator (tests/tools)."""
    from .integrate.wavefront import make_render_step

    if trace_fn is not None:
        return make_render_step(
            cfg, buffers, trace_fn=trace_fn, global_shape=global_shape
        )
    backend, traversal = _resolve(cfg, buffers)
    if backend == "pallas":
        from .kernels.megakernel import make_render_step_gpu

        _dbg("megakernel", tris=buffers.num_tris)
        return make_render_step_gpu(cfg, buffers, global_shape=global_shape)
    _dbg("wavefront(jnp)", traversal=traversal, tris=buffers.num_tris)
    return make_render_step(
        cfg, buffers, trace_fn=select_trace_fn(cfg, buffers),
        global_shape=global_shape,
    )


def select_instanced_render_step(
    cfg: RenderConfig,
    instances,
    global_shape: Optional[tuple] = None,
):
    """Instanced scenes (shared BLASes + per-instance object-to-world
    transforms, the general form of the reference's TLAS-over-one-BLAS,
    ref main.cpp:521-538) are flattened into world-space triangles and
    dispatched like any other scene. Returns (render_step, flat_buffers)."""
    from .accel.instances import flatten_instances
    from .scene import upload

    flat_buffers = upload(flatten_instances(instances))
    _dbg("instanced(flattened)", instances=len(instances))
    step = select_render_step(cfg, flat_buffers, global_shape=global_shape)
    return step, flat_buffers
