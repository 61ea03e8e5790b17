"""Smooth dielectric (mtype 3) tests: MTL `illum >= 4` + `Ni` ingest,
Snell/Fresnel/TIR analytic oracles, furnace energy conservation,
payload-path equivalence, dispatch routing. The reference has no
specular or refractive model at all (ref closesthit.rchit:60-62) — this
is a material-family extension."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfvp_tpu import RenderConfig, init_state, load_obj, make_render_step, upload
from sfvp_tpu.config import CameraConfig
from sfvp_tpu.sampling import dielectric_reflect_refract_soa
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


IOR_GLASS = 1.5
ENC_GLASS = (IOR_GLASS - 1.0) / 4.0  # the rough-column encoding


def test_mtl_illum7_parses_as_dielectric(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl glass\nKd 0 0 0\nKs 0 0 0\nNi 1.5\nillum 7\n"
        "newmtl tinted\nKd 0 0 0\nKs 0.9 0.95 1.0\nNi 1.33\nillum 4\n"
        "newmtl mir\nKd 0 0 0\nKs 1 1 1\nillum 3\n"
    )
    (tmp_path / "s.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "usemtl glass\nf 1 2 3\nusemtl tinted\nf 1 2 3\nusemtl mir\nf 1 2 3\n"
    )
    s = load_obj(str(tmp_path / "s.obj"))
    assert s.face_mat_type.tolist() == [3, 3, 1]
    np.testing.assert_allclose(
        s.face_rough[:2], [(1.5 - 1) / 4, (1.33 - 1) / 4], rtol=1e-6
    )
    # Ks = 0 -> white tint so the glass is not black
    np.testing.assert_allclose(s.face_specular[0], [1, 1, 1])
    np.testing.assert_allclose(s.face_specular[1], [0.9, 0.95, 1.0],
                               rtol=1e-6)


def test_fresnel_normal_incidence():
    """F at normal incidence = ((n-1)/(n+1))^2 = 0.04 for glass."""
    d = (jnp.zeros(1), jnp.zeros(1), -jnp.ones(1))
    n = (jnp.zeros(1), jnp.zeros(1), jnp.ones(1))
    refl, refr, f, tir = dielectric_reflect_refract_soa(
        d, n, jnp.float32(1.5)
    )
    np.testing.assert_allclose(np.asarray(f), [0.04], rtol=1e-5)
    assert not bool(np.asarray(tir)[0])
    # normal incidence: reflection flips, refraction passes straight
    np.testing.assert_allclose(np.asarray(refl[2]), [1.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(refr[2]), [-1.0], atol=1e-6)


def test_snell_law_and_unit_norm():
    """sin(theta_t) = sin(theta_i)/n for air->glass at many angles; the
    refracted direction is unit length; flipped-normal orientation gives
    identical results (the helper reorients internally)."""
    th = np.linspace(0.01, 1.55, 64).astype(np.float32)
    d = (jnp.asarray(np.sin(th)), jnp.zeros(64), -jnp.asarray(np.cos(th)))
    n = (jnp.zeros(64), jnp.zeros(64), jnp.ones(64))
    _, refr, f, tir = dielectric_reflect_refract_soa(d, n, jnp.float32(1.5))
    sin_t = np.asarray(refr[0])
    np.testing.assert_allclose(sin_t, np.sin(th) / 1.5, atol=1e-5)
    norm = np.sqrt(sum(np.asarray(c) ** 2 for c in refr))
    np.testing.assert_allclose(norm, 1.0, atol=1e-5)
    assert not np.asarray(tir).any()
    # a flipped normal means the ray hits the BACK face (glass -> air):
    # entering detection must flip eta, so sin(theta_t) = n sin(theta_i)
    # below the critical angle
    n_fl = (jnp.zeros(64), jnp.zeros(64), -jnp.ones(64))
    _, refr2, _, tir2 = dielectric_reflect_refract_soa(
        d, n_fl, jnp.float32(1.5)
    )
    out = ~np.asarray(tir2)
    assert out.any() and not out.all()
    np.testing.assert_allclose(
        np.asarray(refr2[0])[out], (np.sin(th) * 1.5)[out], atol=1e-5
    )


def test_total_internal_reflection():
    """Glass->air beyond the critical angle (41.8 deg for n=1.5): TIR,
    F = 1, and the reflected direction mirrors about the normal."""
    th = np.asarray([0.6, 0.8, 1.0, 1.2], np.float32)  # critical ~0.7297
    d = (jnp.asarray(np.sin(th)), jnp.zeros(4), jnp.asarray(np.cos(th)))
    # ray travels +z INSIDE glass toward the z=0 interface whose outward
    # normal (air side) is +z: normal points WITH the ray -> exiting
    n = (jnp.zeros(4), jnp.zeros(4), jnp.ones(4))
    refl, _, f, tir = dielectric_reflect_refract_soa(d, n, jnp.float32(1.5))
    crit = np.arcsin(1.0 / 1.5)
    np.testing.assert_array_equal(np.asarray(tir), th > crit)
    np.testing.assert_allclose(np.asarray(f)[th > crit], 1.0)
    np.testing.assert_allclose(np.asarray(refl[0]), np.sin(th), atol=1e-6)
    np.testing.assert_allclose(np.asarray(refl[2]), -np.cos(th), atol=1e-6)


def test_brewster_angle_polarization_split():
    """At Brewster's angle (arctan n) the p-polarized term vanishes:
    F = r_s^2 / 2 exactly."""
    n_g = 1.5
    thb = np.arctan(n_g).astype(np.float32)
    d = (jnp.asarray([np.sin(thb)]), jnp.zeros(1),
         -jnp.asarray([np.cos(thb)]))
    n = (jnp.zeros(1), jnp.zeros(1), jnp.ones(1))
    _, _, f, _ = dielectric_reflect_refract_soa(d, n, jnp.float32(n_g))
    cos_i = np.cos(thb)
    sin_t = np.sin(thb) / n_g
    cos_t = np.sqrt(1 - sin_t**2)
    rs = (cos_i / n_g - cos_t) / (cos_i / n_g + cos_t)
    np.testing.assert_allclose(np.asarray(f), [rs * rs / 2], rtol=1e-4)


_GLASS_PANE = [
    [[-100.0, -100, 0], [100, -100, 0], [100, 100, 0]],
    [[-100.0, -100, 0], [100, 100, 0], [-100, 100, 0]],
]


def test_glass_pane_furnace_energy():
    """Camera faces a huge glass pane inside a uniform sky furnace: every
    path (reflected or transmitted, any interface count) escapes to the
    sky with throughput 1, so the image must equal the sky radiance.
    Catches Fresnel-weight double counting and refraction-direction
    errors in the integrator."""
    scene = _scene(_GLASS_PANE, [0, 0, 0], [0, 0, 0], [1, 1, 1], [3, 3],
                   rough=ENC_GLASS)
    buffers = upload(scene)
    cfg = RenderConfig(
        width=8, height=8, spp_per_step=128, max_depth=6,
        sampling="cosine", sky_emission=(0.6, 0.7, 0.8),
        camera=CameraConfig.look_at(origin=(0.3, 0.1, 3.0),
                                    target=(0, 0, 0), fov_y_deg=40),
    )
    img = _render(cfg, buffers)
    for c, sky in enumerate((0.6, 0.7, 0.8)):
        np.testing.assert_allclose(img[..., c], sky, rtol=2e-2)


def test_glass_tint_applies_per_interface():
    """A tinted zero-thickness pane is ONE interface: every camera path
    (transmitted or reflected) crosses it exactly once before escaping
    to the sky, so the image is exactly tint * sky."""
    tint = 0.8
    scene = _scene(_GLASS_PANE, [0, 0, 0], [0, 0, 0],
                   [tint, tint, tint], [3, 3], rough=ENC_GLASS)
    buffers = upload(scene)
    cfg = RenderConfig(
        width=6, height=6, spp_per_step=256, max_depth=6,
        sampling="cosine", sky_emission=(1.0, 1.0, 1.0),
        camera=CameraConfig.look_at(origin=(0.0, 0.0, 3.0),
                                    target=(0, 0, 0), fov_y_deg=10),
    )
    img = _render(cfg, buffers)
    np.testing.assert_allclose(img, tint, rtol=1e-4)


def test_glass_payload_path_matches_jnp(payload_trace):
    """The integrator's payload path (packed mtype+encoded-IOR value)
    must reproduce the jnp gather path on a glass scene."""
    scene = _scene(_GLASS_PANE, [0, 0, 0], [0, 0, 0], [0.9, 0.95, 1.0],
                   [3, 3], rough=ENC_GLASS)
    buffers = upload(scene)
    cfg = RenderConfig(width=8, height=8, spp_per_step=4, max_depth=4)
    a = _render(cfg, buffers)
    trace = payload_trace(buffers, t_min=cfg.t_min)
    step = jax.jit(make_render_step(cfg, buffers, trace_payload_fn=trace))
    b = np.asarray(step(init_state(8, 8)).accum)
    # the packed value quantizes the encoded IOR to the f32 fraction of
    # 3.x — exact for 0.125
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)


def test_dispatch_dielectric_renders_finite():
    """select_render_step on a dielectric scene routes to the jnp
    integrator (dielectrics are outside the fused kernel's set,
    test_dispatch.py pins the route) and must render finite."""
    from sfvp_tpu.dispatch import select_render_step

    scene = _scene(_GLASS_PANE, [0, 0, 0], [0, 0, 0], [1, 1, 1], [3, 3],
                   rough=ENC_GLASS)
    buffers = upload(scene)
    cfg = RenderConfig(width=8, height=8, spp_per_step=2, max_depth=2)
    step = select_render_step(cfg, buffers)
    assert step.__module__ == "sfvp_tpu.integrate.wavefront"
    out = jax.jit(lambda s: step(s, 0))(init_state(8, 8))
    assert np.isfinite(np.asarray(out.accum)).all()


def test_glass_with_nee_mis_finite_and_consistent(cornell):
    """Cornell with its tall block turned to glass: NEE and NEE+MIS must
    agree with BSDF-only sampling (same transport, different estimators)
    and stay finite — pins the specular-lane NEE gating (shadow rays
    skip mtype 3, emission counted in full after specular bounces)."""
    s = cornell
    # tallBox faces -> glass (material name contains 'tallBox')
    ids = s.face_material_id
    names = s.material_names
    glass = np.asarray(
        [i >= 0 and "tallBox" in names[i] for i in ids], bool
    )
    assert glass.any()
    mt = s.face_mat_type.copy() if s.face_mat_type is not None else np.zeros(
        s.num_triangles, np.int32)
    rg = s.face_rough.copy() if s.face_rough is not None else np.zeros(
        s.num_triangles, np.float32)
    sp = s.face_specular.copy() if s.face_specular is not None else np.zeros(
        (s.num_triangles, 3), np.float32)
    mt[glass] = 3
    rg[glass] = ENC_GLASS
    sp[glass] = 1.0
    scene = dataclasses.replace(
        s, face_mat_type=mt, face_rough=rg, face_specular=sp
    )
    buffers = upload(scene)
    base = RenderConfig(width=12, height=12, spp_per_step=192, max_depth=5,
                        sampling="cosine")
    img_bsdf = _render(base, buffers)
    img_nee = _render(dataclasses.replace(base, use_nee=True), buffers)
    img_mis = _render(
        dataclasses.replace(base, use_nee=True, use_mis=True), buffers
    )
    mb, mn, mm = img_bsdf.mean(), img_nee.mean(), img_mis.mean()
    assert np.isfinite(img_nee).all() and np.isfinite(img_mis).all()
    assert mb > 0
    assert abs(mn - mb) / mb < 0.15, (mn, mb)
    assert abs(mm - mb) / mb < 0.15, (mm, mb)
