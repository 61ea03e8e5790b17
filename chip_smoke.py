"""Chip smoke test: drive the renderer's main paths on one NVIDIA GPU,
check what comes out, and print timings.

    python chip_smoke.py             # one card (what CI runs)
    python chip_smoke.py --cards 4   # DistRenderer on 4 cards vs one card

Phases on one card, in one process (a JAX process reserves most of a
card's memory, so only one may hold it):

  0. card tests: ``pytest -m gpu`` in a child process, before this process
     touches the card;
  1. device: the jax backend must be "gpu"; prints the device kind and
     ``nvidia-smi --query-gpu=name,power.limit``;
  2. CLI main path: ``sfvp_tpu.cli.main`` renders the reference workload
     (Cornell Box, 1024^2, 32 spp per step, depth 8) for 3 steps;
  3. fused Cornell kernel (backend="pallas") against the XLA wavefront
     path (backend="jnp") at that workload: compile time, median and
     spread of >= 5 steps, image agreement; then both against the
     independent NumPy oracle golden at 128^2 x 1024 spp;
  4. BVH path: the 100k-triangle displaced sphere at 512^2, 4 spp,
     NEE + RR + cosine sampling, through ``Renderer``.

With ``--cards 4`` only the multi-card phase runs: Cornell at 1024^2 with
``DistRenderer`` over a 1-D mesh of 4 cards against the same config on
one card.

Any failed check exits non-zero without printing a result. The last line
of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances (see the phase docstrings for the reasons)
KERNEL_VS_XLA_MAX_REL_RMSE = 0.01
ORACLE_MAX_REL_RMSE = 0.02      # BASELINE quality bound (rmse_check.py)
MULTI_CARD_MAX_REL_DIFF = 1e-5


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def precheck() -> None:
    """Refuse early, before any child process or compile, where there is
    plainly no GPU to run on."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not {"cuda", "gpu"} & set(platforms.split(",")):
        raise SmokeFailure(f"JAX_PLATFORMS={platforms!r} excludes the GPU")
    check(shutil.which("nvidia-smi") is not None, "nvidia-smi not found")
    check(os.path.isdir(os.path.join(ROOT, "sfvp_tpu"))
          and os.path.isdir(os.path.join(ROOT, "tests")),
          f"no sfvp_tpu checkout next to {__file__}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def phase_card_tests() -> None:
    """Tests marked ``gpu`` (kernels compiled for the card), run by pytest
    in a child process that exits before this process opens the card."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "tests/",
         "-p", "no:cacheprovider", "-p", "no:xdist"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    tail = out.stdout.strip().splitlines()[-1:] or [""]
    log(f"[card tests] {tail[0]} ({time.perf_counter() - t0:.1f} s)")
    summary = tail[0]
    check(out.returncode == 0 and re.search(r"\d+ passed", summary)
          and not re.search(r"skipped|failed|error", summary),
          "pytest -m gpu did not pass cleanly:\n"
          + out.stdout[-4000:] + out.stderr[-2000:])


def phase_device(count: int):
    import jax

    backend = jax.default_backend()
    check(backend == "gpu", f"jax backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    check(len(devs) >= count, f"need {count} GPUs, jax sees {len(devs)}")
    log(f"[device] {devs[0].device_kind} x{len(devs)} (jax {jax.__version__})")
    log(f"[device] nvidia-smi: {nvidia_smi()}")
    return devs


def _timed_steps(renderer, n):
    """Step ``renderer`` (Renderer or DistRenderer) once to compile, then
    n more times, waiting for the card after each step. Returns (compile +
    first-step seconds, [step seconds] * n)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(renderer.step(1).accum)
    first = time.perf_counter() - t0
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.step(1).accum)
        times.append(time.perf_counter() - t0)
    return first, times


def _spread(times):
    import numpy as np

    t = np.asarray(times)
    q1, med, q3 = np.percentile(t, [25, 50, 75])
    return (f"median {med * 1e3:.2f} ms, min {t.min() * 1e3:.2f}, "
            f"max {t.max() * 1e3:.2f}, IQR {(q3 - q1) * 1e3:.2f} ms "
            f"over {len(t)} steps"), float(med)


def phase_cli(tmp: str) -> None:
    """The reference workload through the CLI a user would call."""
    import numpy as np

    from sfvp_tpu.cli import main as cli_main
    from sfvp_tpu.scene.image_io import decode_png

    png = os.path.join(tmp, "cornell.png")
    jsonl = os.path.join(tmp, "cornell.jsonl")
    t0 = time.perf_counter()
    rc = cli_main(["--width", "1024", "--height", "1024", "--spp", "32",
                   "--max-depth", "8", "--steps", "3", "--out", png,
                   "--log", jsonl, "--quiet"])
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli exited {rc}")
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == 3, f"expected 3 log records, got {len(recs)}")
    for r in recs:
        log(f"[cli] step {r['step']}: {r['step_s'] * 1e3:.1f} ms, "
            f"{r['mrays_per_s']} Mrays/s, avg path {r['avg_path_len']}")
    steady = float(np.median([r["step_s"] for r in recs[1:]]))
    log(f"[cli] compile + first step {recs[0]['step_s']:.2f} s "
        f"(about {recs[0]['step_s'] - steady:.2f} s compile); "
        f"whole CLI call {wall:.2f} s")
    with open(png, "rb") as f:
        img = decode_png(f.read()).astype(np.float32)
    check(img.shape == (1024, 1024, 3), f"PNG shape {img.shape}")
    check(np.isfinite(img).all() and img.max() > 0 and img.mean() > 1.0,
          f"PNG is black or broken (mean {img.mean():.3f})")
    log(f"[cli] PNG ok: mean {img.mean():.2f}/255, max {img.max():.0f}")


def phase_kernel_vs_xla() -> None:
    """The fused Cornell kernel against the XLA wavefront path on the same
    PCG stream. No device matmul is involved, so TF32 does not enter; the
    GPU's sin/cos/sqrt and FMA contraction differ between the two programs
    and can flip single paths, so the comparison is statistical:
    relative RMSE <= 1%. Both paths must also be within the BASELINE 2%
    of the independent NumPy oracle (tools/oracle_ref.py)."""
    import numpy as np

    from sfvp_tpu import Renderer, RenderConfig, load_obj
    from sfvp_tpu.utils.metrics import relative_rmse

    scene = load_obj()
    images, medians = {}, {}
    for backend in ("pallas", "jnp"):
        r = Renderer(RenderConfig(backend=backend), scene)  # 1024^2/32/8
        first, times = _timed_steps(r, 5)
        desc, med = _spread(times)
        segs = float(r.state.mrays) / 6
        log(f"[{backend}] compile + first step {first:.2f} s; {desc}; "
            f"{segs / med:.1f} Mrays/s at the median")
        images[backend] = r.image()
        medians[backend] = med
    a, b = images["pallas"], images["jnp"]
    rel = relative_rmse(a, b)
    frac = float(np.mean(np.abs(a - b) > 1e-3))
    log(f"[kernel vs xla] 6 steps: relative RMSE {rel:.3e}, "
        f"max |diff| {np.abs(a - b).max():.3e}, share of values with "
        f"|diff| > 1e-3: {frac:.4f}")
    check(np.isfinite(a).all(), "kernel image not finite")
    check(rel <= KERNEL_VS_XLA_MAX_REL_RMSE,
          f"kernel vs XLA relative RMSE {rel} > {KERNEL_VS_XLA_MAX_REL_RMSE}")
    log(f"[kernel vs xla] speed-up at the median: "
        f"{medians['jnp'] / medians['pallas']:.2f}x")

    golden = os.path.join(ROOT, "tests", "golden", "oracle_128_1024spp.npz")
    with np.load(golden) as z:
        ref, frames, spp = z["accum"], int(z["frames"]), int(z["spp"])
    h, w = ref.shape[:2]
    for backend in ("pallas", "jnp"):
        r = Renderer(RenderConfig(width=w, height=h, spp_per_step=spp,
                                  backend=backend), scene)
        rel = relative_rmse(r.run(frames, progress=False), ref)
        log(f"[oracle] {backend}: {w}x{h}, {frames * spp} spp, relative "
            f"RMSE vs oracle golden {rel:.3e}")
        check(rel <= ORACLE_MAX_REL_RMSE,
              f"{backend} vs oracle {rel} > {ORACLE_MAX_REL_RMSE}")


def phase_bvh() -> None:
    """The BVH path at a real size: 100k-tri displaced sphere."""
    import numpy as np

    from sfvp_tpu import Renderer, RenderConfig
    from sfvp_tpu.config import CameraConfig
    from sfvp_tpu.scene.procedural import sphere_mesh

    scene = sphere_mesh(n_lat=223, n_lon=223, bump=0.3)  # as --scene-tris 100000
    cam = CameraConfig.look_at(origin=(0.0, 2.2, 5.0), target=(0.0, 0.0, 0.0),
                               fov_y_deg=50.0)
    cfg = RenderConfig(width=512, height=512, spp_per_step=4, camera=cam,
                       sky_emission=(0.8, 0.85, 1.0), sampling="cosine",
                       use_nee=True, use_rr=True)
    t0 = time.perf_counter()
    r = Renderer(cfg, scene)
    setup = time.perf_counter() - t0
    first, times = _timed_steps(r, 1)
    img = r.image()
    segs = float(r.state.mrays) / 2
    log(f"[bvh] {scene.num_triangles} tris, 512^2 x 4 spp, NEE+RR+cosine: "
        f"set-up (BVH build) {setup:.2f} s, compile + first step "
        f"{first:.2f} s, step {times[0] * 1e3:.1f} ms, "
        f"{segs / times[0]:.2f} Mrays/s")
    check(np.isfinite(img).all() and img.max() > 0,
          "BVH render not finite or black")
    log(f"[bvh] image ok: mean {img.mean():.4f}")


def phase_multi_card(devs) -> None:
    """Row-sharded DistRenderer over 4 cards against one card. Rays use
    global pixel coordinates, so the images should be identical; allow
    1e-5 relative for reduction-order effects."""
    import numpy as np

    from sfvp_tpu import Renderer, RenderConfig, load_obj
    from sfvp_tpu.dist import DistRenderer, default_mesh

    cfg = RenderConfig()
    scene = load_obj()
    d = DistRenderer(cfg, scene, mesh=default_mesh(devs[:4]))
    first, times = _timed_steps(d, 5)
    desc, med = _spread(times)
    log(f"[4 cards] compile + first step {first:.2f} s; {desc}; "
        f"{float(d.state.mrays) / 6 / med:.1f} Mrays/s")
    sharded = d.image()
    r = Renderer(cfg, scene)
    first1, times1 = _timed_steps(r, 5)
    desc1, med1 = _spread(times1)
    log(f"[1 card] compile + first step {first1:.2f} s; {desc1}; "
        f"{float(r.state.mrays) / 6 / med1:.1f} Mrays/s")
    single = r.image()
    diff = float(np.abs(sharded - single).max())
    rel = diff / max(float(np.abs(single).max()), 1e-12)
    log(f"[4 cards vs 1] max |diff| {diff:.3e} (relative {rel:.3e})")
    check(rel <= MULTI_CARD_MAX_REL_DIFF,
          f"4-card image differs from 1-card by {rel} relative")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    a = p.parse_args(argv)
    try:
        precheck()
        if a.cards == 1:
            phase_card_tests()
        sys.path.insert(0, ROOT)
        from sfvp_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        devs = phase_device(a.cards)
        if a.cards == 4:
            phase_multi_card(devs)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                phase_cli(tmp)
            phase_kernel_vs_xla()
            phase_bvh()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    import jax

    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
