"""Adaptive sampling (integrate/adaptive.py): warmup equals the uniform
renderer exactly, the tile selector targets high-variance regions, and the
adaptive estimate stays consistent with the uniform one."""

import numpy as np
import jax
import pytest

from sfvp_tpu import RenderConfig, init_state, load_obj, make_render_step, upload
from sfvp_tpu.integrate.adaptive import (
    AdaptiveRenderer,
    adaptive_image,
    init_adaptive_state,
    make_adaptive_steps,
)


@pytest.fixture(scope="module")
def cornell_buf():
    return upload(load_obj())


def test_warmup_matches_uniform_renderer(cornell_buf):
    """Two uniform adaptive steps == two plain render steps (same seeds,
    same running mean)."""
    cfg = RenderConfig(width=32, height=32, spp_per_step=2, max_depth=3)
    uni, _ = make_adaptive_steps(cfg, cornell_buf, tile=16)
    st = init_adaptive_state(32, 32)
    st = jax.jit(uni)(st)
    st = jax.jit(uni)(st)

    step = jax.jit(make_render_step(cfg, cornell_buf))
    ref = step(step(init_state(32, 32)))
    np.testing.assert_allclose(
        np.asarray(adaptive_image(st)), np.asarray(ref.accum),
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_allclose(float(st.mrays), float(ref.mrays), rtol=1e-6)


def test_adaptive_targets_noisy_tiles(cornell_buf):
    """After warmup, adaptive steps must concentrate samples: the sample-
    count map becomes nonuniform, and every adaptive step renders exactly
    K tiles."""
    cfg = RenderConfig(width=32, height=32, spp_per_step=2, max_depth=4)
    uni, ada = make_adaptive_steps(cfg, cornell_buf, frac=0.25, tile=8)
    st = init_adaptive_state(32, 32)
    st = jax.jit(uni)(st)
    st = jax.jit(uni)(st)
    ada_j = jax.jit(ada)
    for _ in range(4):
        st = ada_j(st)
    count = np.asarray(st.count)
    # 16 tiles, K = 4 per adaptive step: exactly 4*64 pixel-steps added/step
    assert count.min() == 2
    assert count.max() >= 3
    added = count.sum() - 2 * 32 * 32
    assert added == 4 * 4 * 64  # steps * K * tile^2


def test_adaptive_estimate_consistent(cornell_buf):
    """The adaptive image converges to the uniform image (loose MC
    tolerance on a tiny render)."""
    cfg = RenderConfig(width=16, height=16, spp_per_step=8, max_depth=3,
                       sampling="cosine")
    r = AdaptiveRenderer(cfg, load_obj(), frac=0.5, tile=8, warmup=2)
    img_a = r.run(steps=8, progress=False)

    step = jax.jit(make_render_step(cfg, cornell_buf))
    st = init_state(16, 16)
    for _ in range(8):
        st = step(st)
    img_u = np.asarray(st.accum)
    assert np.isfinite(img_a).all()
    # same scene, same estimator family: means must agree to MC noise
    assert abs(img_a.mean() - img_u.mean()) / img_u.mean() < 0.1


def test_adaptive_uses_dispatch_trace_on_bvh(cornell_buf):
    """The adaptive sampler shares the full-frame loop's trace selection:
    a bvh config traces through the jnp BVH (dispatch.select_trace_fn),
    and its estimate matches the brute-force trace on equal steps."""
    from sfvp_tpu.kernels.intersect import trace_brute_jnp

    cfg = RenderConfig(width=32, height=32, spp_per_step=1, max_depth=2,
                       traversal="bvh")

    def run(trace_fn=None):
        uni, ada = make_adaptive_steps(cfg, cornell_buf, tile=16,
                                       trace_fn=trace_fn)
        st = jax.jit(uni)(init_adaptive_state(32, 32))  # warmup
        st = jax.jit(ada)(st)                            # adaptive wave
        return np.asarray(adaptive_image(st))

    img = run()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, run(trace_brute_jnp), rtol=1e-4,
                               atol=1e-6)


def test_indivisible_tile_raises(cornell_buf):
    cfg = RenderConfig(width=20, height=20, spp_per_step=1)
    with pytest.raises(ValueError, match="not divisible"):
        make_adaptive_steps(cfg, cornell_buf, tile=16)


def test_adaptive_checkpoint_resume(tmp_path, cornell_buf):
    """Resume continues the adaptive estimator exactly (same counts, same
    image as an uninterrupted run)."""
    from sfvp_tpu import load_obj

    cfg = RenderConfig(width=16, height=16, spp_per_step=2, max_depth=2)
    p = str(tmp_path / "ada.npz")
    r1 = AdaptiveRenderer(cfg, load_obj(), frac=0.5, tile=8, warmup=2)
    r1.run(steps=3, checkpoint_path=p, progress=False)

    r2 = AdaptiveRenderer(cfg, load_obj(), frac=0.5, tile=8, warmup=2)
    r2.resume(p)
    assert int(r2.state.frame) == 3
    img_resumed = r2.run(steps=2, progress=False)

    r3 = AdaptiveRenderer(cfg, load_obj(), frac=0.5, tile=8, warmup=2)
    img_straight = r3.run(steps=5, progress=False)
    np.testing.assert_allclose(img_resumed, img_straight, rtol=1e-6,
                               atol=1e-7)

    # wrong config refuses
    import dataclasses
    import pytest as _pytest

    bad = dataclasses.replace(cfg, spp_per_step=4)
    rb = AdaptiveRenderer(bad, load_obj(), frac=0.5, tile=8)
    with _pytest.raises(ValueError, match="refusing"):
        rb.resume(p)
