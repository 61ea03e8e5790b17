"""Adaptive sampling — variance-driven progressive rendering (extension;
the reference samples every pixel uniformly forever, ref raygen.rgen:43).

Formulation: per-pixel *continuous* sample counts are dynamic
shapes, so adaptivity happens at TILE granularity with a STATIC budget:
every adaptive step renders exactly K = ceil(frac * n_tiles) tiles — the
ones with the highest estimated relative variance of their pixel means —
as one fixed-size ray wave (lax.top_k + gathered pixel coordinates; no
recompilation, no dynamic shapes).

Estimator: each pixel accumulates the running sum s1 and sum of squares
s2 of its per-step sample means plus a step count n. The image is s1/n;
the priority of a tile is the mean over its pixels of
Var[step mean]/n / (luma^2 + eps) — i.e. estimated *relative* error of
the current pixel estimate. Like all adaptive MC, stopping criteria based
on the estimates themselves introduce a (vanishing) bias; the estimator
itself is the plain sample mean.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig


class AdaptiveState(NamedTuple):
    s1: jnp.ndarray     # (H, W, 3) f32 sum of per-step sample means
    s2: jnp.ndarray     # (H, W, 3) f32 sum of squared per-step sample means
    count: jnp.ndarray  # (H, W)   i32 steps rendered per pixel
    frame: jnp.ndarray  # ()       i32 global step counter (seed stream)
    mrays: jnp.ndarray  # ()       f32 cumulative traced segments / 1e6


def init_adaptive_state(height: int, width: int) -> AdaptiveState:
    return AdaptiveState(
        s1=jnp.zeros((height, width, 3), jnp.float32),
        s2=jnp.zeros((height, width, 3), jnp.float32),
        count=jnp.zeros((height, width), jnp.int32),
        frame=jnp.zeros((), jnp.int32),
        mrays=jnp.zeros((), jnp.float32),
    )


def adaptive_image(state: AdaptiveState) -> jnp.ndarray:
    n = jnp.maximum(state.count, 1).astype(jnp.float32)[..., None]
    return state.s1 / n


def make_adaptive_steps(
    cfg: RenderConfig,
    buffers,
    frac: float = 0.25,
    tile: int = 16,
    trace_fn=None,
):
    """Returns (uniform_step, adaptive_step), both
    AdaptiveState -> AdaptiveState and jittable:

    - uniform_step renders every pixel once (warmup / fallback);
    - adaptive_step renders only the top-``frac`` tiles by estimated
      relative variance (static K-tile wave).
    """
    h, w = cfg.height, cfg.width
    if h % tile or w % tile:
        raise ValueError(
            f"image {w}x{h} not divisible by adaptive tile size {tile}"
        )
    from ..dispatch import select_trace_fn
    from .wavefront import make_render_step

    if trace_fn is None:
        trace_fn = select_trace_fn(cfg, buffers)
    base_step = make_render_step(cfg, buffers, trace_fn=trace_fn)
    render_pixels = base_step.render_pixels
    spp = np.float32(cfg.spp_per_step)

    tpw = w // tile
    tph = h // tile
    n_tiles = tpw * tph
    k_tiles = max(1, int(np.ceil(frac * n_tiles)))

    def _scatter(state: AdaptiveState, px, py, color_sum, segs):
        mean = jnp.stack(
            [c / spp for c in color_sum], axis=-1
        )  # (N, 3) per-pixel sample mean of this step
        s1 = state.s1.at[py, px].add(mean)
        s2 = state.s2.at[py, px].add(mean * mean)
        count = state.count.at[py, px].add(1)
        return AdaptiveState(
            s1=s1, s2=s2, count=count,
            frame=state.frame + 1,
            mrays=state.mrays + segs / np.float32(1e6),
        )

    def uniform_step(state: AdaptiveState) -> AdaptiveState:
        idx = jnp.arange(h * w, dtype=jnp.int32)
        px = idx % w
        py = idx // w
        color_sum, segs = render_pixels(px, py, state.frame)
        return _scatter(state, px, py, color_sum, segs)

    def adaptive_step(state: AdaptiveState) -> AdaptiveState:
        n = jnp.maximum(state.count, 1).astype(jnp.float32)
        mean = state.s1 / n[..., None]
        # unbiased variance of the step means, over per-pixel luma
        var = jnp.maximum(
            state.s2 / n[..., None] - mean * mean, 0.0
        ) * (n / jnp.maximum(n - 1.0, 1.0))[..., None]
        luma = mean.sum(axis=-1)
        rel = (var.sum(axis=-1) / n) / (luma * luma + 1e-4)
        # pixels never sampled twice get top priority
        rel = jnp.where(state.count < 2, jnp.float32(1e30), rel)
        tiles = rel.reshape(tph, tile, tpw, tile).mean(axis=(1, 3))
        _, tid = jax.lax.top_k(tiles.reshape(-1), k_tiles)

        # decode the K winning tiles into a (K * tile * tile,) pixel wave
        within = jnp.arange(tile * tile, dtype=jnp.int32)
        px = ((tid % tpw)[:, None] * tile + within[None, :] % tile).reshape(-1)
        py = ((tid // tpw)[:, None] * tile + within[None, :] // tile).reshape(-1)
        color_sum, segs = render_pixels(px, py, state.frame)
        return _scatter(state, px, py, color_sum, segs)

    return uniform_step, adaptive_step


class AdaptiveRenderer:
    """Progressive renderer with variance-driven tile selection: ``warmup``
    uniform steps, then adaptive steps touching only the noisiest
    ``frac`` of tiles. API mirrors render.driver.Renderer where it can."""

    def __init__(self, cfg: RenderConfig, scene, frac: float = 0.25,
                 tile: int = 16, warmup: int = 2):
        from ..scene import upload
        from ..utils.cache import enable_compilation_cache

        enable_compilation_cache()
        self.cfg = cfg
        self.frac = frac
        self.tile = tile
        self.warmup = warmup
        if isinstance(scene, (list, tuple)):
            # instanced scene: flattened, as Renderer/DistRenderer do
            from ..accel.instances import flatten_instances

            scene = flatten_instances(scene)
        self.buffers = upload(scene)
        uni, ada = make_adaptive_steps(cfg, self.buffers, frac=frac,
                                       tile=tile)
        self._uniform = jax.jit(uni, donate_argnums=(0,))
        self._adaptive = jax.jit(ada, donate_argnums=(0,))
        self.state = init_adaptive_state(cfg.height, cfg.width)

    def step(self, n: int = 1) -> AdaptiveState:
        for _ in range(n):
            if int(self.state.frame) < self.warmup:
                self.state = self._uniform(self.state)
            else:
                self.state = self._adaptive(self.state)
        return self.state

    def image(self) -> np.ndarray:
        return np.asarray(adaptive_image(self.state))

    # -- checkpoint / resume (same contract as render/checkpoint.py: the
    # config hash must match, the running estimator continues exactly) ---
    def save_checkpoint(self, path: str) -> None:
        import os

        tmp = path + ".tmp"
        np.savez(
            tmp,
            version=np.int32(1),
            kind=np.bytes_(b"adaptive"),
            s1=np.asarray(self.state.s1),
            s2=np.asarray(self.state.s2),
            count=np.asarray(self.state.count),
            frame=np.asarray(self.state.frame),
            mrays=np.asarray(self.state.mrays),
            config_hash=np.bytes_(self.cfg.config_hash().encode()),
            # the adaptive knobs determine WHERE samples go; resume must
            # refuse a renderer that would change the distribution mid-run
            frac=np.float32(self.frac),
            tile=np.int32(self.tile),
            warmup=np.int32(self.warmup),
        )
        os.replace(tmp + ".npz", path)

    def resume(self, path: str) -> None:
        import jax.numpy as jnp

        with np.load(path) as z:
            got = bytes(z["config_hash"]).decode()
            want = self.cfg.config_hash()
            if got != want:
                raise ValueError(
                    f"checkpoint config hash {got} != expected {want}; "
                    "refusing to resume into a different render "
                    "configuration"
                )
            if bytes(z["kind"]) != b"adaptive":
                raise ValueError("not an adaptive-sampling checkpoint")
            got_knobs = (float(z["frac"]), int(z["tile"]), int(z["warmup"]))
            want_knobs = (float(self.frac), int(self.tile),
                          int(self.warmup))
            if got_knobs != want_knobs:
                raise ValueError(
                    f"checkpoint adaptive knobs (frac, tile, warmup)="
                    f"{got_knobs} != renderer {want_knobs}; refusing to "
                    "change the sampling distribution mid-run"
                )
            self.state = AdaptiveState(
                s1=jnp.asarray(z["s1"]),
                s2=jnp.asarray(z["s2"]),
                count=jnp.asarray(z["count"]),
                frame=jnp.asarray(z["frame"]),
                mrays=jnp.asarray(z["mrays"]),
            )

    def run(self, steps: int, out: Optional[str] = None,
            srgb: bool = False, progress: bool = True,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0) -> np.ndarray:
        import time

        t0 = time.perf_counter()
        for i in range(steps):
            self.step()
            if progress:
                jax.block_until_ready(self.state.s1)
                now = time.perf_counter()
                print(
                    f"step {int(self.state.frame):5d}  "
                    f"{(now - t0) * 1e3:8.1f} ms  "
                    f"mean spp "
                    f"{float(self.state.count.mean()) * self.cfg.spp_per_step:.1f}",
                    flush=True,
                )
                t0 = now
            if (checkpoint_path and checkpoint_every
                    and (i + 1) % checkpoint_every == 0):
                self.save_checkpoint(checkpoint_path)
        img = self.image()
        if out:
            from ..render.driver import write_image

            write_image(out, img, srgb=srgb)
        if checkpoint_path:
            self.save_checkpoint(checkpoint_path)
        return img
