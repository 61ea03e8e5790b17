"""Progressive render driver — the analog of the reference's frame loop
(ref main.cpp:643-685): step the jitted integrator, optionally writing PNG
frames, JSONL metrics, and checkpoints, with async dispatch and explicit
blocking only at observation boundaries.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import jax
import numpy as np

from ..config import RenderConfig
from ..integrate.wavefront import RenderState, init_state
from ..scene import Scene, upload
from .checkpoint import load_checkpoint, save_checkpoint
from .exr import write_exr
from .png import tonemap_srgb_u8, tonemap_unorm_u8, write_png


def write_image(path: str, img_f32: np.ndarray, srgb: bool = False) -> None:
    """Write by extension: .exr = linear f32 HDR; anything else = PNG
    through the unorm (reference-parity) or sRGB tonemap."""
    if path.lower().endswith(".exr"):
        write_exr(path, img_f32)
    else:
        tonemap = tonemap_srgb_u8 if srgb else tonemap_unorm_u8
        write_png(path, tonemap(img_f32))


class Renderer:
    """Owns the jitted render step plus progressive state for one scene/config.

    Usage:
        r = Renderer(cfg, scene)
        r.run(steps=32, out="out.png")

    ``scene`` may also be a list of ``accel.instances.Instance``; such
    scenes are flattened (dispatch.select_instanced_render_step)."""

    def __init__(
        self,
        cfg: RenderConfig,
        scene,
        trace_fn: Optional[Callable] = None,
        donate: bool = True,
    ):
        from ..dispatch import select_instanced_render_step, select_render_step
        from ..utils.cache import enable_compilation_cache

        enable_compilation_cache()
        self.cfg = cfg
        self.scene = scene
        if isinstance(scene, (list, tuple)):
            if trace_fn is not None:
                raise ValueError(
                    "trace_fn cannot be combined with an instanced scene"
                )
            step, self.buffers = select_instanced_render_step(cfg, scene)
        else:
            self.buffers = upload(scene)
            step = select_render_step(cfg, self.buffers, trace_fn=trace_fn)
        if cfg.debug_nan:
            # debug sanitizer (SURVEY §5): trap NaN-producing ops at their
            # source; the run() loop additionally asserts a finite
            # accumulator at every observed boundary
            jax.config.update("jax_debug_nans", True)
        self._step = jax.jit(
            lambda s: step(s), donate_argnums=(0,) if donate else ()
        )
        self.state = init_state(cfg.height, cfg.width)

    def resume(self, checkpoint_path: str) -> None:
        self.state, _ = load_checkpoint(checkpoint_path, self.cfg.config_hash())

    def _save_checkpoint(self, path: str) -> None:
        save_checkpoint(path, self.state, self.cfg.config_hash())

    def step(self, n: int = 1) -> RenderState:
        for _ in range(n):
            self.state = self._step(self.state)
        return self.state

    def image(self) -> np.ndarray:
        """Current progressive estimate, (H, W, 3) float32 on host."""
        return np.asarray(self.state.accum)

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
        return run_progressive(
            self, steps, out=out, frame_every=frame_every,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, log_path=log_path,
            srgb=srgb, progress=progress, preview_port=preview_port,
        )


def run_progressive(
    r,
    steps: int,
    out: Optional[str] = None,
    frame_every: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    log_path: Optional[str] = None,
    srgb: bool = False,
    progress: bool = True,
    preview_port: Optional[int] = None,
    extra_rec: Optional[dict] = None,
) -> np.ndarray:
    """THE progressive loop (ref main.cpp:643-685 analog), shared by
    ``Renderer.run`` and ``dist.DistRenderer.run`` so preview, debug_nan
    and logging behavior cannot drift between the single- and multi-chip
    drivers. ``r`` provides ``_step``/``state``/``cfg``/``image()``/
    ``_save_checkpoint()``; ``extra_rec`` is merged into every JSONL
    record and appended to the progress line."""
    log_f = open(log_path, "a") if log_path else None
    preview = None
    if preview_port is not None:
        from .preview import PreviewServer

        preview = PreviewServer(port=preview_port, srgb=srgb)
        if progress:
            print(f"live preview: http://127.0.0.1:{preview.port}/",
                  flush=True)
    spp_step = r.cfg.spp_per_step
    suffix = ""
    if extra_rec:
        suffix = "  [" + " ".join(
            f"{v} {k}" for k, v in extra_rec.items()) + "]"
    try:
        t_prev = time.perf_counter()
        mrays_prev = float(r.state.mrays)
        for i in range(steps):
            r.state = r._step(r.state)
            # observe only at logging/export boundaries
            last = i == steps - 1
            boundary = (
                last
                or (frame_every and (i + 1) % frame_every == 0)
                or (checkpoint_every and (i + 1) % checkpoint_every == 0)
                or progress
                or log_f is not None
            )
            if not boundary:
                continue
            jax.block_until_ready(r.state.accum)
            if r.cfg.debug_nan and not bool(
                np.isfinite(r.image()).all()
            ):
                raise FloatingPointError(
                    f"non-finite accumulator at step {int(r.state.frame)}"
                )
            now = time.perf_counter()
            frame = int(r.state.frame)
            mrays_tot = float(r.state.mrays)
            n_samples = r.cfg.width * r.cfg.height * spp_step
            rec = {
                "step": frame,
                "spp": frame * spp_step,
                "step_s": round(now - t_prev, 5),
                "mrays_step": round(mrays_tot - mrays_prev, 3),
                "mrays_per_s": round(
                    (mrays_tot - mrays_prev) / max(now - t_prev, 1e-9), 2
                ),
                # mean traced segments per path — the wavefront
                # occupancy signal (max_depth = nothing terminated)
                "avg_path_len": round(
                    (mrays_tot - mrays_prev) * 1e6 / n_samples, 3
                ),
            }
            if extra_rec:
                rec.update(extra_rec)
            t_prev, mrays_prev = now, mrays_tot
            if log_f:
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
            if progress:
                print(
                    f"step {rec['step']:5d}  spp {rec['spp']:7d}  "
                    f"{rec['step_s']*1e3:8.1f} ms  "
                    f"{rec['mrays_per_s']:8.1f} Mray/s" + suffix,
                    flush=True,
                )
            if preview is not None:
                preview.update(r.image())
            if frame_every and (i + 1) % frame_every == 0 and out:
                base, ext = os.path.splitext(out)
                write_image(f"{base}_step{frame:05d}{ext or '.png'}",
                            r.image(), srgb=srgb)
            if (
                checkpoint_path
                and checkpoint_every
                and (i + 1) % checkpoint_every == 0
            ):
                r._save_checkpoint(checkpoint_path)
        img = r.image()
        if out:
            write_image(out, img, srgb=srgb)
        if checkpoint_path:
            r._save_checkpoint(checkpoint_path)
        return img
    finally:
        if log_f:
            log_f.close()
        if preview is not None:
            preview.close()


def render(cfg: RenderConfig, scene: Scene, steps: int, **kwargs) -> np.ndarray:
    """One-shot convenience: render ``steps`` progressive steps, return the
    (H, W, 3) float32 image."""
    return Renderer(cfg, scene).run(steps, **kwargs)
