"""Row-sharded rendering over a 1-D device mesh (shard_map + psum).

Design (SURVEY.md §2 parallelism table, BASELINE config 5):

  - the accumulator ``(H, W, 3)`` is sharded along rows, ``P(AXIS)``;
    each device owns ``H / n_devices`` contiguous rows;
  - the per-shard step is the UNMODIFIED single-device ``render_step``:
    it already takes ``row0`` (the global row offset) and generates
    rays in global pixel coordinates, so an N-device render is
    pixel-identical to the 1-device render of the same config
    (pinned by tests/test_dist.py::test_sharded_equals_single);
  - devices own disjoint pixels, so the image needs NO collective at
    all; only the scalar Mrays counter crosses devices (one f32 ``psum``
    per step);
  - ``frame`` is replicated and advances identically everywhere.

The reference has no distributed analog — its launch is one
``traceRaysKHR(W, H, 1)`` on one queue (ref main.cpp:659).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..integrate.wavefront import RenderState, make_render_step

AXIS = "rows"

shard_map = jax.shard_map


def default_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) local devices."""
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.asarray(devices), (AXIS,))


def _state_specs() -> RenderState:
    return RenderState(accum=P(AXIS, None, None), frame=P(), mrays=P())


def make_sharded_render_step(
    cfg: RenderConfig,
    buffers,
    mesh: Mesh,
    trace_fn: Optional[Callable] = None,
    trace_payload_fn: Optional[Callable] = None,
):
    """Returns ``(step, init)``:

    ``init() -> RenderState`` with the accumulator row-sharded over
    ``mesh``; ``step(state) -> state`` runs one progressive step on every
    device's own rows (jit-compiled shard_map; scene buffers are closed over
    and replicated).

    Explicit ``trace_fn``/``trace_payload_fn`` pin the integrator's trace
    implementation (tests); by default the backend dispatch picks it
    exactly as the single-device ``Renderer`` does.
    """
    n = int(mesh.devices.size)
    if cfg.height % n != 0:
        raise ValueError(
            f"image height {cfg.height} is not divisible by the mesh's "
            f"{n} devices; pad the framebuffer or resize the mesh"
        )
    h_local = cfg.height // n
    gshape = (cfg.height, cfg.width)

    if trace_fn is not None or trace_payload_fn is not None:
        local_step = make_render_step(
            cfg,
            buffers,
            trace_fn=trace_fn,
            global_shape=gshape,
            trace_payload_fn=trace_payload_fn,
        )
    else:
        from ..dispatch import select_render_step

        local_step = select_render_step(cfg, buffers, global_shape=gshape)

    def shard_body(state: RenderState) -> RenderState:
        row0 = jax.lax.axis_index(AXIS) * h_local
        local = RenderState(
            accum=state.accum,
            frame=state.frame,
            mrays=jnp.zeros((), jnp.float32),
        )
        out = local_step(local, row0)
        # disjoint pixel tiles: the image itself needs no collective;
        # only the segment counter is reduced (one scalar psum)
        delta = jax.lax.psum(out.mrays, AXIS)
        return RenderState(
            accum=out.accum, frame=out.frame, mrays=state.mrays + delta
        )

    specs = _state_specs()
    step = jax.jit(
        shard_map(
            shard_body,
            mesh=mesh,
            in_specs=(specs,),
            out_specs=specs,
            check_vma=False,
        )
    )

    def init() -> RenderState:
        from .multihost import make_global_array

        n_local = sum(
            d.process_index == jax.process_index() for d in mesh.devices.flat
        )
        fully_local = n_local == n
        rows_here = cfg.height if fully_local else h_local * n_local
        return RenderState(
            accum=make_global_array(
                mesh, P(AXIS, None, None),
                np.zeros((rows_here, cfg.width, 3), np.float32),
            ),
            frame=make_global_array(mesh, P(), np.zeros((), np.int32)),
            mrays=make_global_array(mesh, P(), np.zeros((), np.float32)),
        )

    return step, init


class DistRenderer:
    """Multi-device counterpart of ``render.driver.Renderer``: same API
    (step/image/run/resume), state row-sharded over a device mesh,
    per-shard checkpoints (no host gather on the checkpoint path)."""

    def __init__(
        self,
        cfg: RenderConfig,
        scene,
        mesh: Optional[Mesh] = None,
        trace_fn: Optional[Callable] = None,
        trace_payload_fn: Optional[Callable] = None,
    ):
        from ..scene import upload
        from ..utils.cache import enable_compilation_cache
        from .multihost import init_distributed

        enable_compilation_cache()
        if mesh is None:
            # multi-host runs (JAX_COORDINATOR_ADDRESS etc.) bootstrap the
            # distributed runtime before the default mesh enumerates
            # devices; a single process is a no-op
            init_distributed()
        self.cfg = cfg
        self.scene = scene
        self.mesh = mesh if mesh is not None else default_mesh()
        if isinstance(scene, (list, tuple)):
            # instanced scene: flattened, as the single-device Renderer
            # does (dispatch.select_instanced_render_step)
            from ..accel.instances import flatten_instances

            if trace_fn is not None or trace_payload_fn is not None:
                raise ValueError(
                    "explicit trace fns cannot be combined with an "
                    "instanced scene"
                )
            scene = flatten_instances(scene)
        self.buffers = upload(scene)
        self._step, init = make_sharded_render_step(
            cfg,
            self.buffers,
            self.mesh,
            trace_fn=trace_fn,
            trace_payload_fn=trace_payload_fn,
        )
        self.state = init()

    # -- state ------------------------------------------------------------
    def step(self, n: int = 1) -> RenderState:
        for _ in range(n):
            self.state = self._step(self.state)
        return self.state

    def image(self) -> np.ndarray:
        """Current progressive estimate, gathered to host (H, W, 3) f32.
        This is the ONLY cross-shard data movement in the pipeline (an
        all-gather over DCN on multi-host meshes)."""
        from .multihost import fetch_global

        return fetch_global(self.state.accum)

    def resume(self, checkpoint_path: str) -> None:
        from ..render.checkpoint import load_checkpoint_sharded

        self.state, _ = load_checkpoint_sharded(
            checkpoint_path, self.mesh, self.cfg.config_hash()
        )

    def _save_checkpoint(self, path: str) -> None:
        from ..render.checkpoint import save_checkpoint_sharded

        save_checkpoint_sharded(path, self.state, self.cfg.config_hash())

    # -- progressive loop (the SHARED implementation in render/driver.py;
    # dist adds the device count to every record/progress line and gains
    # preview + debug_nan support for free) ------------------------------
    def run(
        self,
        steps: int,
        out: Optional[str] = None,
        frame_every: int = 0,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        log_path: Optional[str] = None,
        srgb: bool = False,
        progress: bool = True,
        preview_port: Optional[int] = None,
    ) -> np.ndarray:
        from ..render.driver import run_progressive

        return run_progressive(
            self, steps, out=out, frame_every=frame_every,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, log_path=log_path,
            srgb=srgb, progress=progress, preview_port=preview_port,
            extra_rec={"devices": int(self.mesh.devices.size)},
        )
