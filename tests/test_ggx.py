"""GGX glossy BRDF (mtype 2) tests: MTL `Pr` ingest, VNDF sampling
correctness (pdf integration + energy), mirror limit, NEE/MIS
consistency. The reference has no specular model at all
(ref closesthit.rchit:60-62) — this is a BASELINE config-3 extension."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfvp_tpu import RenderConfig, init_state, load_obj, make_render_step, upload
from sfvp_tpu.sampling import (
    ggx_d,
    ggx_lambda,
    ggx_sample_vndf_local,
    ggx_vndf_pdf,
)
from sfvp_tpu.scene.objload import Scene


def _scene(tris, diffuse, emission, specular=None, mat_type=None, rough=None):
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
        face_rough=full(rough if rough is not None else 0, (t,)),
    )


def _render(cfg, buffers, steps=1):
    step = jax.jit(make_render_step(cfg, buffers))
    state = init_state(cfg.height, cfg.width)
    for _ in range(steps):
        state = step(state)
    return np.asarray(state.accum)


_MIRROR_WALL = [
    [[-100.0, -100, 0], [100, -100, 0], [100, 100, 0]],
    [[-100.0, -100, 0], [100, 100, 0], [-100, 100, 0]],
]


def test_mtl_pr_parses_as_glossy(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl gl\nKd 0 0 0\nKs 0.9 0.8 0.7\nillum 3\nPr 0.25\n"
        "newmtl mir\nKd 0 0 0\nKs 1 1 1\nillum 3\n"
    )
    (tmp_path / "s.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "usemtl gl\nf 1 2 3\nusemtl mir\nf 1 2 3\n"
    )
    s = load_obj(str(tmp_path / "s.obj"))
    assert s.face_mat_type.tolist() == [2, 1]
    np.testing.assert_allclose(s.face_rough, [0.25, 0.0], rtol=1e-6)


def test_vndf_pdf_integrates_to_one():
    """Monte-Carlo check: E[1/pdf] over VNDF samples of the reflected
    direction equals the solid angle covered... instead verify the sampled
    h-distribution against D_vis by importance ratio: for samples h ~ VNDF,
    E[ D_vis(h) / pdf_h(h) ] == 1 with pdf_h = D_vis (self-consistency) and
    the reflected-direction pdf ggx_vndf_pdf matches the h pdf via the
    Jacobian 1/(4 cos_oh)."""
    g = np.random.default_rng(5)
    n = 200_000
    r1 = jnp.asarray(g.uniform(size=n).astype(np.float32))
    r2 = jnp.asarray(g.uniform(size=n).astype(np.float32))
    alpha = jnp.float32(0.3)
    wo = (jnp.full(n, 0.45, jnp.float32), jnp.zeros(n, jnp.float32),
          jnp.full(n, np.sqrt(1 - 0.45**2), jnp.float32))
    h = ggx_sample_vndf_local(r1, r2, wo, alpha)
    woz = wo[2]
    cos_oh = wo[0] * h[0] + wo[1] * h[1] + wo[2] * h[2]
    # analytic VNDF density of h: G1(wo) D(h) max(0, wo.h) / wo.z
    g1 = 1.0 / (1.0 + ggx_lambda(woz, alpha))
    pdf_h = g1 * ggx_d(h[2], alpha) * jnp.maximum(cos_oh, 0.0) / woz
    # estimate the integral of a smooth function f supported only on the
    # VNDF's support (wo.h > 0) two ways: with VNDF importance weights vs
    # with uniform sampling — they must agree (validates BOTH sampler and
    # density). f must vanish where pdf_h == 0 for the estimators to target
    # the same integral.
    f = jnp.maximum(cos_oh, 0.0) ** 2
    est_vndf = float(jnp.mean(f / jnp.maximum(pdf_h, 1e-12)))
    # uniform-hemisphere reference for integral of f over h
    u1 = jnp.asarray(g.uniform(size=n).astype(np.float32))
    u2 = jnp.asarray(g.uniform(size=n).astype(np.float32))
    z = u1
    s = jnp.sqrt(jnp.maximum(0.0, 1 - z * z))
    phi = 2 * np.pi * u2
    hu = (jnp.cos(phi) * s, jnp.sin(phi) * s, z)
    cos_oh_u = wo[0][0] * hu[0] + wo[1][0] * hu[1] + wo[2][0] * hu[2]
    fu = jnp.maximum(cos_oh_u, 0.0) ** 2
    est_unif = float(jnp.mean(fu) * 2 * np.pi)
    assert abs(est_vndf - est_unif) / est_unif < 0.02, (est_vndf, est_unif)


def test_reflected_pdf_jacobian():
    """ggx_vndf_pdf (pdf of the REFLECTED direction) must equal
    pdf_h / (4 cos_oh)."""
    g = np.random.default_rng(6)
    n = 1000
    r1 = jnp.asarray(g.uniform(size=n).astype(np.float32))
    r2 = jnp.asarray(g.uniform(size=n).astype(np.float32))
    alpha = jnp.float32(0.45)
    wo = (jnp.full(n, 0.6, jnp.float32), jnp.zeros(n, jnp.float32),
          jnp.full(n, 0.8, jnp.float32))
    h = ggx_sample_vndf_local(r1, r2, wo, alpha)
    cos_oh = wo[0] * h[0] + wo[1] * h[1] + wo[2] * h[2]
    g1 = 1.0 / (1.0 + ggx_lambda(wo[2], alpha))
    pdf_h = g1 * ggx_d(h[2], alpha) * jnp.maximum(cos_oh, 0.0) / wo[2]
    pdf_wi = ggx_vndf_pdf(wo[2], h[2], alpha)
    np.testing.assert_allclose(
        np.asarray(pdf_wi), np.asarray(pdf_h / (4 * cos_oh)), rtol=1e-4
    )


def test_rough_zero_limit_matches_mirror():
    """rough -> 0 GGX with F0 = Ks converges to the perfect mirror."""
    spec = [0.5, 0.25, 0.125]
    cfg = RenderConfig(width=8, height=8, spp_per_step=32, max_depth=3)
    mirror = _scene(_MIRROR_WALL, [0, 0, 0], [0, 0, 0], spec, [1, 1])
    glossy = _scene(_MIRROR_WALL, [0, 0, 0], [0, 0, 0], spec, [2, 2],
                    rough=0.015)
    a = _render(cfg, upload(mirror))
    b = _render(cfg, upload(glossy))
    np.testing.assert_allclose(b, a, rtol=0.05, atol=5e-3)


def test_white_furnace_energy_bounded():
    """F0 = 1 glossy wall under a unit-white sky: the image can never
    exceed the sky radiance (energy conservation; single-scattering GGX
    loses a little energy at high roughness, it must never gain)."""
    cfg = dataclasses.replace(
        RenderConfig(width=8, height=8, spp_per_step=64, max_depth=4),
        sky_emission=(1.0, 1.0, 1.0),
    )
    for rough in (0.1, 0.5, 0.9):
        sc = _scene(_MIRROR_WALL, [0, 0, 0], [0, 0, 0], [1, 1, 1], [2, 2],
                    rough=rough)
        img = _render(cfg, upload(sc))
        assert img.max() <= 1.0 + 1e-4, (rough, img.max())
        # pixel (0,0) is excluded: the reference's seed formula
        # (pixel * m, ref raygen.rgen:47) degenerates to one repeated
        # sample there, which an absorbed GGX path can black out entirely
        rest = img.reshape(-1, 3)[1:]
        # single-scattering GGX loses energy as roughness grows (multiple
        # scattering is not modeled); it must stay well above zero
        assert rest.min() >= 0.2, (rough, rest.min())


def test_glossy_nee_matches_bsdf_only():
    """A glossy floor lit by an area light: NEE estimate must agree with
    the BSDF-only estimate (unbiasedness of the glossy NEE eval)."""
    big = 4.0
    tris = [
        # floor at y=0 (normal convention follows the winding used by the
        # mirror tests: -cross points +y for this order)
        [[-big, 0, -big], [big, 0, -big], [big, 0, big]],
        [[-big, 0, -big], [big, 0, big], [-big, 0, big]],
        # small emissive quad above
        [[-0.4, 2.0, -0.4], [0.4, 2.0, -0.4], [0.4, 2.0, 0.4]],
        [[-0.4, 2.0, -0.4], [0.4, 2.0, 0.4], [-0.4, 2.0, 0.4]],
    ]
    scene = Scene(
        vertices=np.asarray(tris, np.float32).reshape(-1, 3),
        indices=np.arange(12, dtype=np.uint32),
        face_diffuse=np.zeros((4, 3), np.float32),
        face_emission=np.asarray(
            [[0, 0, 0], [0, 0, 0], [8, 8, 8], [8, 8, 8]], np.float32),
        face_specular=np.asarray(
            [[0.9, 0.9, 0.9]] * 2 + [[0, 0, 0]] * 2, np.float32),
        face_mat_type=np.asarray([2, 2, 0, 0], np.int32),
        face_rough=np.asarray([0.4, 0.4, 0, 0], np.float32),
    )
    from sfvp_tpu.config import CameraConfig

    cam = CameraConfig.look_at(origin=(0.0, 1.4, 3.2), target=(0, 0, 0),
                               fov_y_deg=45)
    base = RenderConfig(width=12, height=12, spp_per_step=256, max_depth=3,
                        camera=cam, sampling="cosine",
                        sky_emission=(0.0, 0.0, 0.0))
    buffers = upload(scene)
    img_bsdf = _render(base, buffers)
    img_nee = _render(dataclasses.replace(base, use_nee=True), buffers)
    img_mis = _render(
        dataclasses.replace(base, use_nee=True, use_mis=True), buffers
    )
    mb, mn, mm = img_bsdf.mean(), img_nee.mean(), img_mis.mean()
    assert mb > 0
    assert abs(mn - mb) / mb < 0.15, (mn, mb)
    assert abs(mm - mb) / mb < 0.15, (mm, mb)
    assert np.isfinite(img_nee).all() and np.isfinite(img_mis).all()


def test_glossy_payload_path_matches_jnp(payload_trace):
    """The integrator's payload path (packed mtype+rough value) must
    reproduce the jnp gather path on a glossy scene."""
    spec = [0.8, 0.7, 0.6]
    scene = _scene(_MIRROR_WALL, [0, 0, 0], [0, 0, 0], spec, [2, 2],
                   rough=0.3)
    buffers = upload(scene)
    cfg = RenderConfig(width=8, height=8, spp_per_step=4, max_depth=3)
    a = _render(cfg, buffers)
    trace = payload_trace(buffers, t_min=cfg.t_min)
    step = jax.jit(make_render_step(cfg, buffers, trace_payload_fn=trace))
    b = np.asarray(step(init_state(8, 8)).accum)
    # packed roughness is quantized by the f32 fraction — exact here
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)


def test_dispatch_routes_glossy_to_wavefront(tmp_path):
    """select_render_step on a glossy scene must not pick the fused
    kernel."""
    from sfvp_tpu.dispatch import select_render_step

    scene = _scene(_MIRROR_WALL, [0, 0, 0], [0, 0, 0], [1, 1, 1], [2, 2],
                   rough=0.5)
    buffers = upload(scene)
    cfg = RenderConfig(width=8, height=8, spp_per_step=2, max_depth=2)
    step = select_render_step(cfg, buffers)
    assert step.__module__ == "sfvp_tpu.integrate.wavefront"
    out = jax.jit(lambda s: step(s, 0))(init_state(8, 8))
    assert np.isfinite(np.asarray(out.accum)).all()


def test_textured_glossy_mixed_scene(tmp_path):
    """A scene mixing a textured diffuse face and a glossy face renders
    finite through the wavefront route."""
    from sfvp_tpu.render.png import encode_png

    img = np.full((4, 4, 3), 200, np.uint8)
    (tmp_path / "t.png").write_bytes(encode_png(img))
    (tmp_path / "m.mtl").write_text(
        "newmtl tex\nKd 1 1 1\nmap_Kd t.png\n"
        "newmtl gl\nKd 0 0 0\nKs 0.9 0.9 0.9\nillum 3\nPr 0.3\n"
    )
    (tmp_path / "s.obj").write_text(
        "mtllib m.mtl\n"
        "v -2 -1 0\nv 0 -1 0\nv 0 1 0\nv -2 1 0\n"
        "v 0 -1 0\nv 2 -1 0\nv 2 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl tex\nf 1/1 2/2 3/3 4/4\n"
        "usemtl gl\nf 5 6 7 8\n"
    )
    from sfvp_tpu import RenderConfig, load_obj, make_render_step, init_state, upload
    from sfvp_tpu.config import CameraConfig
    from sfvp_tpu.dispatch import select_render_step

    buffers = upload(load_obj(str(tmp_path / "s.obj")))
    assert buffers.has_textures
    assert bool((np.asarray(buffers.mtype)[:buffers.num_tris] == 2).any())
    cam = CameraConfig.look_at(origin=(0, 0, 3), target=(0, 0, 0),
                               fov_y_deg=60)
    cfg = RenderConfig(width=16, height=16, spp_per_step=4, max_depth=3,
                       camera=cam, sampling="cosine")
    step = select_render_step(cfg, buffers)
    out = jax.jit(lambda s: step(s, 0))(init_state(16, 16))
    img_out = np.asarray(out.accum)
    assert np.isfinite(img_out).all() and img_out.max() > 0
