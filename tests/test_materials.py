"""Material extensions (BASELINE config 3): mirror BRDF + next-event
estimation. All OFF in parity mode; these tests exercise the extended
paths against analytic and statistical oracles."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfvp_tpu import RenderConfig, init_state, load_obj, make_render_step, upload
from sfvp_tpu.integrate.lights import build_light_table, sample_light
from sfvp_tpu.scene.objload import Scene
from sfvp_tpu.scene.buffers import from_arrays


def _scene(tris, diffuse, emission, specular=None, mat_type=None):
    tris = np.asarray(tris, np.float32)
    t = len(tris)

    def full(x, shape):
        return np.broadcast_to(np.asarray(x, np.float32), shape).copy()

    return Scene(
        vertices=tris.reshape(-1, 3),
        indices=np.arange(3 * t, dtype=np.uint32),
        face_diffuse=full(diffuse, (t, 3)),
        face_emission=full(emission, (t, 3)),
        face_specular=full(specular if specular is not None else 0, (t, 3)),
        face_mat_type=np.asarray(
            mat_type if mat_type is not None else np.zeros(t), np.int32
        ),
    )


def _render(cfg, buffers, steps=1):
    step = jax.jit(make_render_step(cfg, buffers))
    state = init_state(cfg.height, cfg.width)
    for _ in range(steps):
        state = step(state)
    return np.asarray(state.accum)


def test_mtl_illum3_parses_as_mirror(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl mir\nKd 0 0 0\nKs 0.9 0.8 0.7\nillum 3\n"
        "newmtl dif\nKd 0.5 0.5 0.5\nKs 0 0 0\nillum 2\n"
    )
    (tmp_path / "s.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "usemtl mir\nf 1 2 3\nusemtl dif\nf 1 2 3\n"
    )
    s = load_obj(str(tmp_path / "s.obj"))
    assert s.face_mat_type.tolist() == [1, 0]
    np.testing.assert_allclose(s.face_specular[0], [0.9, 0.8, 0.7], rtol=1e-6)


def test_mirror_reflects_sky_tint():
    """Camera looks at a huge mirror; reflected rays escape to the sky:
    pixel = sky (first segment adds nothing: Ke=0) * ... actually
    mirror adds no emission; bounce reflects; miss adds spec*sky."""
    big = 100.0
    # mirror wall at z=0 facing the camera (+z side)
    tris = [
        [[-big, -big, 0], [big, -big, 0], [big, big, 0]],
        [[-big, -big, 0], [big, big, 0], [-big, big, 0]],
    ]
    spec = [0.5, 0.25, 0.125]
    scene = _scene(tris, [0, 0, 0], [0, 0, 0], spec, [1, 1])
    cfg = RenderConfig(width=8, height=8, spp_per_step=8, max_depth=3)
    img = _render(cfg, upload(scene))
    expected = np.asarray(spec) * np.asarray(cfg.sky_emission)
    np.testing.assert_allclose(
        img, np.broadcast_to(expected, img.shape), rtol=1e-5, atol=1e-6
    )


def test_mirror_megakernel_equivalence():
    """The fused Cornell kernel's mirror path (interpret mode) must match
    the jnp integrator."""
    from sfvp_tpu.kernels.megakernel import make_render_step_gpu

    big = 100.0
    tris = [
        [[-big, -big, 0], [big, -big, 0], [big, big, 0]],
        [[-big, -big, 0], [big, big, 0], [-big, big, 0]],
    ]
    scene = _scene(tris, [0.2, 0.2, 0.2], [0, 0, 0], [0.9, 0.8, 0.7], [1, 0])
    buffers = upload(scene)
    cfg = RenderConfig(width=16, height=8, spp_per_step=1, max_depth=2)
    a = jax.jit(make_render_step(cfg, buffers))(init_state(8, 16))
    b = jax.jit(make_render_step_gpu(cfg, buffers, interpret=True))(
        init_state(8, 16)
    )
    np.testing.assert_allclose(np.asarray(b.accum), np.asarray(a.accum),
                               rtol=1e-5, atol=1e-6)
    assert float(a.mrays) == float(b.mrays)


def test_light_table_cornell(cornell):
    lt = build_light_table(cornell)
    assert lt is not None and lt.num == 2
    # light quad is 0.47 x 0.38 at y=-1.98 (flipped)
    assert lt.total_area == pytest.approx(0.47 * 0.38, rel=1e-4)
    np.testing.assert_allclose(
        np.asarray(lt.le[0]), [17.0, 17.0], rtol=1e-6
    )


def test_sample_light_distribution(cornell):
    lt = build_light_table(cornell)
    g = np.random.default_rng(0)
    n = 20000
    r_sel = jnp.asarray(g.random(n, dtype=np.float32))
    r1 = jnp.asarray(g.random(n, dtype=np.float32))
    r2 = jnp.asarray(g.random(n, dtype=np.float32))
    pt, nrm, le, pdf = sample_light(lt, r_sel, r1, r2)
    pts = np.stack([np.asarray(c) for c in pt], axis=1)
    # all samples on the light plane y=-1.98
    np.testing.assert_allclose(pts[:, 1], -1.98, atol=1e-5)
    assert pts[:, 0].min() >= -0.24 - 1e-5 and pts[:, 0].max() <= 0.23 + 1e-5
    # rough area uniformity in x
    hist, _ = np.histogram(pts[:, 0], bins=8, range=(-0.24, 0.23))
    assert np.all(np.abs(hist - n / 8) < 6 * np.sqrt(n / 8))
    assert float(pdf) == pytest.approx(1.0 / lt.total_area, rel=1e-5)


def test_nee_matches_bsdf_sampling(cornell):
    """NEE and plain BSDF sampling estimate the same integral; at moderate
    spp the two means must agree within Monte-Carlo tolerance."""
    buffers = upload(cornell)
    base = RenderConfig(
        width=16, height=16, spp_per_step=256, max_depth=4, spp_chunk=8,
        sampling="cosine",
    )
    nee = dataclasses.replace(base, use_nee=True)
    img_a = _render(base, buffers, steps=2)
    img_b = _render(nee, buffers, steps=2)
    rel = abs(img_a.mean() - img_b.mean()) / img_a.mean()
    assert rel < 0.03, rel


def test_nee_reduces_variance(cornell):
    """The whole point of NEE: per-pixel variance at equal spp must drop
    substantially on the directly lit Cornell floor."""
    buffers = upload(cornell)

    def render_pair(use_nee):
        imgs = []
        for frame_seed in range(2):
            cfg = RenderConfig(
                width=16, height=16, spp_per_step=16, max_depth=3,
                sampling="cosine", use_nee=use_nee,
            )
            step = jax.jit(make_render_step(cfg, buffers))
            st = init_state(16, 16)
            # different frames -> independent sample sets
            from sfvp_tpu.integrate.wavefront import RenderState

            st = RenderState(
                accum=st.accum,
                frame=jnp.asarray(frame_seed * 7, jnp.int32),
                mrays=st.mrays,
            )
            imgs.append(np.asarray(step(st).accum) * (frame_seed * 7 + 1))
        return imgs

    a1, a2 = render_pair(False)
    b1, b2 = render_pair(True)
    var_bsdf = ((a1 - a2) ** 2).mean()
    var_nee = ((b1 - b2) ** 2).mean()
    assert var_nee < var_bsdf * 0.5, (var_nee, var_bsdf)


def test_many_lights_nee_no_cliff():
    """>64 area lights must not raise (VERDICT r1 weak #10): dispatch
    routes NEE to the scalable wavefront path and the estimate stays
    unbiased vs the BSDF-only estimator."""
    import dataclasses

    import jax

    from sfvp_tpu.config import CameraConfig
    from sfvp_tpu.dispatch import select_render_step
    from sfvp_tpu.integrate.lights import build_light_table_from_buffers
    from sfvp_tpu.integrate.wavefront import init_state

    g = np.random.default_rng(2)
    # floor + a 10x10 grid of small emissive quads above it
    tris = [
        [[-6, 0, -6], [6, 0, -6], [6, 0, 6]],
        [[-6, 0, -6], [6, 0, 6], [-6, 0, 6]],
    ]
    kd = [[0.7, 0.7, 0.7]] * 2
    ke = [[0, 0, 0]] * 2
    for i in range(10):
        for j in range(10):
            x, z = i - 4.5, j - 4.5
            tris.append([[x - .2, 2, z - .2], [x + .2, 2, z + .2],
                         [x + .2, 2, z - .2]])
            kd.append([0, 0, 0])
            ke.append([6.0, 5.0, 4.0])
    buffers = from_arrays(
        np.asarray(tris, np.float32), np.asarray(kd, np.float32),
        np.asarray(ke, np.float32),
    )
    lt = build_light_table_from_buffers(buffers)
    assert lt.num == 100

    cam = CameraConfig.look_at(origin=(0, 1.0, 8.0), target=(0, 0.5, 0),
                               fov_y_deg=45)
    cfg = RenderConfig(width=16, height=16, spp_per_step=128, max_depth=2,
                       sampling="cosine", camera=cam,
                       sky_emission=(0, 0, 0), use_nee=True)
    step = jax.jit(select_render_step(cfg, buffers))  # must not raise
    st = step(init_state(16, 16))
    img = np.asarray(st.accum)
    assert np.isfinite(img).all() and img.mean() > 0

    ref = jax.jit(select_render_step(
        dataclasses.replace(cfg, use_nee=False, spp_per_step=512),
    buffers))(init_state(16, 16))
    rel = abs(img.mean() - float(np.asarray(ref.accum).mean())) / max(
        float(np.asarray(ref.accum).mean()), 1e-9)
    assert rel < 0.08, rel
