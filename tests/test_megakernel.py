"""Fused Cornell kernel (kernels/megakernel.py) against the jnp wavefront
integrator.

On the CPU the kernel runs in the Pallas interpreter, where it executes
the same ops in the same order as the jnp integrator, so images match to
within the regen-kernel tolerance (rtol 1e-5, atol 1e-6) and the segment
counts exactly. Interpret mode is slow, so the cases stay tiny. The
compiled kernel is checked on the card by ``test_compiled_kernel_matches_jnp``
(marker ``gpu``, run by chip_smoke.py) and at full size by chip_smoke.py.
"""

import numpy as np
import jax
import pytest

from sfvp_tpu import RenderConfig, init_state, load_obj, make_render_step, upload
from sfvp_tpu.kernels.megakernel import (
    make_render_step_gpu, scene_table, unsupported,
)


@pytest.fixture(scope="module")
def buffers():
    return upload(load_obj())


def _mirror_buffers():
    """Cornell box with the tall block turned into a tinted mirror."""
    scene = load_obj()
    t = scene.num_triangles
    mt = np.zeros((t,), np.int32)
    mt[-12:] = 1
    spec = np.zeros((t, 3), np.float32)
    spec[-12:] = (0.9, 0.8, 0.7)
    scene.face_mat_type = mt
    scene.face_specular = spec
    return upload(scene)


def _compare(cfg, buffers, steps=1, interpret=True):
    step_jnp = jax.jit(make_render_step(cfg, buffers))
    step_gpu = jax.jit(make_render_step_gpu(cfg, buffers, interpret=interpret))
    a = init_state(cfg.height, cfg.width)
    b = init_state(cfg.height, cfg.width)
    for _ in range(steps):
        a = step_jnp(a)
        b = step_gpu(b)
    np.testing.assert_allclose(
        np.asarray(b.accum), np.asarray(a.accum), rtol=1e-5, atol=1e-6)
    return a, b


@pytest.mark.parametrize("mirror", [False, True], ids=["diffuse", "mirror"])
@pytest.mark.parametrize("rr", [False, True], ids=["no_rr", "rr"])
@pytest.mark.parametrize("sampling", ["uniform", "cosine"])
def test_kernel_matches_jnp(buffers, sampling, rr, mirror):
    bufs = _mirror_buffers() if mirror else buffers
    if mirror:
        assert not unsupported(RenderConfig(), bufs)
    cfg = RenderConfig(width=16, height=16, spp_per_step=2, max_depth=3,
                       sampling=sampling, use_rr=rr, rr_start_depth=1)
    a, b = _compare(cfg, bufs)
    assert float(a.mrays) == float(b.mrays)


def test_megakernel_bitwise_equivalence(buffers):
    """Parity config at a tiny size: same bits as the jnp integrator."""
    cfg = RenderConfig(width=16, height=8, spp_per_step=1, max_depth=2)
    a, b = _compare(cfg, buffers)
    np.testing.assert_array_equal(np.asarray(a.accum), np.asarray(b.accum))
    assert float(a.mrays) == float(b.mrays)


def test_megakernel_second_frame_and_accum(buffers):
    """The running mean over steps (frame counter read in-kernel)."""
    cfg = RenderConfig(width=8, height=8, spp_per_step=2, max_depth=2)
    _, b = _compare(cfg, buffers, steps=2)
    assert int(b.frame) == 2


def test_megakernel_cosine_mode(buffers):
    cfg = RenderConfig(
        width=8, height=8, spp_per_step=1, max_depth=1, sampling="cosine"
    )
    _compare(cfg, buffers)


def test_megakernel_nondivisible_wave(buffers):
    """Pixel count not a multiple of the block (24x8 = 192 pixels, block
    128): the tail program masks its loads and stores and still matches."""
    cfg = RenderConfig(width=24, height=8, spp_per_step=1, max_depth=1)
    step_jnp = jax.jit(make_render_step(cfg, buffers))
    step_gpu = jax.jit(make_render_step_gpu(cfg, buffers, interpret=True))
    a = step_jnp(init_state(8, 24))
    b = step_gpu(init_state(8, 24))
    np.testing.assert_allclose(
        np.asarray(b.accum), np.asarray(a.accum), rtol=1e-5, atol=1e-6)
    assert float(a.mrays) == float(b.mrays)


def test_megakernel_row_offset(buffers):
    """row0 (sharded band): rendering rows [4, 8) of an 8-row image must
    equal that band of the full render."""
    cfg = RenderConfig(width=16, height=8, spp_per_step=1, max_depth=2)
    full = np.asarray(jax.jit(make_render_step_gpu(cfg, buffers,
                                                   interpret=True))(
        init_state(8, 16)).accum)
    band_step = make_render_step_gpu(cfg, buffers, global_shape=(8, 16),
                                     interpret=True)
    band = np.asarray(
        jax.jit(lambda s: band_step(s, row0=4))(init_state(4, 16)).accum)
    np.testing.assert_array_equal(band, full[4:])


def test_kernel_refuses_cpu_without_interpret(buffers):
    """Off the GPU the factory raises instead of silently interpreting."""
    assert jax.default_backend() == "cpu"
    with pytest.raises(ValueError, match="GPU only"):
        make_render_step_gpu(RenderConfig(width=8, height=8), buffers)


def test_kernel_refuses_unsupported_config(buffers):
    with pytest.raises(ValueError, match="next-event estimation"):
        make_render_step_gpu(RenderConfig(width=8, height=8, use_nee=True),
                             buffers, interpret=True)


def test_unsupported_lists_each_feature(buffers, tmp_path):
    from sfvp_tpu.config import CameraConfig
    from sfvp_tpu.scene.buffers import from_arrays

    assert unsupported(RenderConfig(), buffers) == []
    cfg = RenderConfig(use_nee=True,
                       camera=CameraConfig(lens_radius=0.1, focus_dist=3.0))
    g = np.random.default_rng(0)
    tris = g.uniform(-1, 1, (4, 3, 3)).astype(np.float32)
    z = np.zeros((4, 3), np.float32)
    bufs = from_arrays(tris, z, z, specular=z + 0.5,
                       mat_type=np.asarray([0, 1, 2, 3], np.int32),
                       rough=np.full(4, 0.3, np.float32))
    assert unsupported(cfg, bufs) == [
        "next-event estimation", "thin-lens depth of field",
        "GGX glossy material", "dielectric material",
    ]


def test_scene_table_layout(buffers):
    tbl = np.asarray(scene_table(buffers))
    assert tbl.shape == (20, buffers.padded_tris)
    np.testing.assert_array_equal(tbl[0], np.asarray(buffers.v0x))
    np.testing.assert_array_equal(tbl[12], np.asarray(buffers.er))
    np.testing.assert_array_equal(tbl[15], np.asarray(buffers.sr))
    np.testing.assert_array_equal(tbl[18], np.asarray(buffers.mtype, dtype=np.float32))
    np.testing.assert_array_equal(tbl[19], np.asarray(buffers.rough))


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp(gpu_backend, buffers):
    """The kernel as compiled for the card against the jnp integrator on
    the same card (64^2, parity config, mirror and cosine+RR variants).
    The GPU's sin/cos/sqrt and FMA contraction differ between the two
    programs and can flip single paths, so the check is statistical:
    relative RMSE <= 1%."""
    for bufs, kw in ((buffers, {}), (_mirror_buffers(),
                                     dict(sampling="cosine", use_rr=True))):
        cfg = RenderConfig(width=64, height=64, spp_per_step=4, **kw)
        a = jax.jit(make_render_step(cfg, bufs))(init_state(64, 64))
        b = jax.jit(make_render_step_gpu(cfg, bufs))(init_state(64, 64))
        a, b = np.asarray(a.accum), np.asarray(b.accum)
        assert np.isfinite(b).all()
        rel = np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(a ** 2))
        assert rel <= 0.01, rel
