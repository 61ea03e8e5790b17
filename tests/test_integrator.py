"""Integrator correctness: analytic furnace-style scenes + invariance
properties of the wavefront formulation (parity target:
ref shaders/raygen.rgen:41-91)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfvp_tpu import RenderConfig, init_state, load_obj, make_render_step, upload
from sfvp_tpu.scene.objload import Scene


def _render(cfg, buffers, steps=1):
    step = jax.jit(make_render_step(cfg, buffers))
    state = init_state(cfg.height, cfg.width)
    for _ in range(steps):
        state = step(state)
    return np.asarray(state.accum), state


def _scene_from_tris(tris, diffuse, emission):
    tris = np.asarray(tris, np.float32)
    t = len(tris)
    return Scene(
        vertices=tris.reshape(-1, 3),
        indices=np.arange(3 * t, dtype=np.uint32),
        face_diffuse=np.broadcast_to(
            np.asarray(diffuse, np.float32), (t, 3)
        ).copy(),
        face_emission=np.broadcast_to(
            np.asarray(emission, np.float32), (t, 3)
        ).copy(),
    )


def _closed_box_tris(half=6.0):
    """12 triangles forming a closed cube enclosing the camera at (0,-1,5),
    wound so the reference normal convention -cross(e01,e02) points inward."""
    h = half
    corners = np.array(
        [[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)],
        np.float32,
    )
    quads = [
        (0, 1, 3, 2),  # x = -h
        (4, 6, 7, 5),  # x = +h
        (0, 4, 5, 1),  # y = -h
        (2, 3, 7, 6),  # y = +h
        (0, 2, 6, 4),  # z = -h
        (1, 5, 7, 3),  # z = +h
    ]
    tris = []
    for (a, b, c, d) in quads:
        tris.append(corners[[a, b, c]])
        tris.append(corners[[a, c, d]])
    return np.asarray(tris, np.float32)


SMALL = dict(width=16, height=16, max_depth=8)


def test_empty_scene_is_sky():
    """No geometry -> every ray misses on segment 0 -> image == sky
    exactly (weight 1 * (0.7, 0.6, 0.5), ref miss.rmiss:10)."""
    cfg = RenderConfig(spp_per_step=4, **SMALL)
    scene = _scene_from_tris(np.zeros((1, 3, 3)), [0, 0, 0], [0, 0, 0])
    img, _ = _render(cfg, upload(scene))
    np.testing.assert_allclose(img, np.broadcast_to([0.7, 0.6, 0.5], img.shape))


def test_black_box_is_black():
    """Closed non-emissive box -> no light -> (near-)zero. A handful of
    f32 edge-grazing rays may slip through triangle seams (the reference's
    hardware traversal has the same property), so allow a tiny bound."""
    cfg = RenderConfig(spp_per_step=4, **SMALL)
    scene = _scene_from_tris(_closed_box_tris(), [0.5, 0.5, 0.5], [0, 0, 0])
    img, _ = _render(cfg, upload(scene))
    assert float(np.abs(img).max()) < 1e-4


def test_emissive_box_one_bounce():
    """Closed box, Ke=E, Kd=0: first hit adds E, weight then becomes 0 ->
    image == E exactly."""
    cfg = RenderConfig(spp_per_step=4, **SMALL)
    e = [2.0, 3.0, 4.0]
    scene = _scene_from_tris(_closed_box_tris(), [0, 0, 0], e)
    img, _ = _render(cfg, upload(scene))
    np.testing.assert_allclose(img, np.broadcast_to(e, img.shape), rtol=1e-6)


def test_furnace_depth_series():
    """Closed box with Kd=rho and Ke=E everywhere: expected radiance after
    D segments is E * sum_{k=0}^{D-1} rho^k (geometric series). The uniform-
    hemisphere estimator is unbiased, so the Monte-Carlo mean must approach
    this analytically known value."""
    rho, e = 0.5, 1.0
    cfg = RenderConfig(
        width=8, height=8, spp_per_step=512, max_depth=6, spp_chunk=8
    )
    scene = _scene_from_tris(_closed_box_tris(), [rho] * 3, [e] * 3)
    img, _ = _render(cfg, upload(scene), steps=4)
    expected = e * sum(rho**k for k in range(cfg.max_depth))
    got = img.mean()
    assert abs(got - expected) / expected < 0.02, (got, expected)


def test_accumulation_running_mean(cornell):
    """(color + old*frame)/(frame+1) (ref raygen.rgen:88-90): two steps
    must equal the mean of the two per-step images."""
    cfg = RenderConfig(spp_per_step=2, **SMALL)
    buffers = upload(cornell)
    step = jax.jit(make_render_step(cfg, buffers))
    s0 = init_state(cfg.height, cfg.width)
    s1 = step(s0)
    s2 = step(s1)
    # step images: frame0 image = s1.accum; frame1 image = 2*s2 - s1
    img1 = np.asarray(s1.accum)
    img2 = np.asarray(s2.accum)
    # re-render frame1 alone by seeding state with frame=1 and zero accum
    from sfvp_tpu.integrate.wavefront import RenderState

    s1b = RenderState(
        accum=jnp.zeros_like(s0.accum), frame=jnp.asarray(1, jnp.int32),
        mrays=jnp.zeros(()),
    )
    f1 = np.asarray(step(s1b).accum) * 2.0  # (img + 0*1)/2 -> img/2
    np.testing.assert_allclose(img2, (img1 + f1) / 2.0, rtol=1e-5, atol=1e-6)


def test_spp_chunk_invariance(cornell):
    """Folding samples into the wave must not change the image beyond f32
    summation order."""
    buffers = upload(cornell)
    imgs = []
    for chunk in (1, 2, 4):
        cfg = RenderConfig(
            width=16, height=16, spp_per_step=4, max_depth=4, spp_chunk=chunk
        )
        img, _ = _render(cfg, buffers)
        imgs.append(img)
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(imgs[0], imgs[2], rtol=1e-5, atol=1e-6)


def test_uniform_vs_cosine_converge_to_same_image(cornell):
    """Both samplers are unbiased estimators of the same integral; at high
    spp the images must agree statistically."""
    buffers = upload(cornell)
    imgs = {}
    for sampling in ("uniform", "cosine"):
        cfg = RenderConfig(
            width=24,
            height=24,
            spp_per_step=256,
            max_depth=6,
            spp_chunk=8,
            sampling=sampling,
        )
        img, _ = _render(cfg, buffers, steps=2)
        imgs[sampling] = img
    a, b = imgs["uniform"], imgs["cosine"]
    denom = np.maximum(np.abs(a).mean(), 1e-3)
    rmse = np.sqrt(((a - b) ** 2).mean()) / denom
    assert rmse < 0.12, rmse


def test_rr_unbiased(cornell):
    """Russian roulette keeps the estimator unbiased (statistical check)."""
    buffers = upload(cornell)
    base_cfg = RenderConfig(
        width=16, height=16, spp_per_step=512, max_depth=8, spp_chunk=8,
        sampling="cosine",
    )
    rr_cfg = dataclasses.replace(base_cfg, use_rr=True, rr_start_depth=2)
    img_a, _ = _render(base_cfg, buffers, steps=2)
    img_b, _ = _render(rr_cfg, buffers, steps=2)
    diff = np.abs(img_a.mean() - img_b.mean()) / img_a.mean()
    assert diff < 0.05, diff


def test_mrays_counter(cornell):
    cfg = RenderConfig(spp_per_step=2, **SMALL)
    _, state = _render(cfg, upload(cornell))
    mrays = float(state.mrays)
    n_rays = 16 * 16 * 2  # pixels * spp
    # every ray traces at least 1 and at most max_depth segments
    assert n_rays / 1e6 <= mrays <= n_rays * 8 / 1e6


def test_integrator_payload_path_matches_jnp(cornell_buffers, payload_trace):
    """The trace_payload_fn hook (shading from a Payload, per-bounce ray
    sort) == the gather-based integrator on identical sample streams;
    the sort permutes rays and scatters colors back, so only f32
    summation order may differ."""
    cfg = RenderConfig(width=16, height=8, spp_per_step=2, max_depth=3)
    trace = payload_trace(cornell_buffers, t_min=cfg.t_min)
    step_pay = jax.jit(
        make_render_step(cfg, cornell_buffers, trace_payload_fn=trace))
    step_jnp = jax.jit(make_render_step(cfg, cornell_buffers))
    a = step_pay(init_state(8, 16))
    b = step_jnp(init_state(8, 16))
    np.testing.assert_allclose(np.asarray(a.accum), np.asarray(b.accum),
                               rtol=1e-5, atol=1e-6)
    assert float(a.mrays) == float(b.mrays)


def test_integrator_nee_with_occlusion_kernel(cornell_buffers, payload_trace):
    """Payload trace + a dedicated any-hit occlusion_fn for NEE shadow
    rays == the jnp NEE integrator."""
    from sfvp_tpu.kernels.intersect import trace_brute_jnp

    cfg = RenderConfig(width=16, height=8, spp_per_step=1, max_depth=2,
                       use_nee=True, sampling="cosine")

    def occluded(o, d, t_max, active=None):
        hit = trace_brute_jnp(o, d, cornell_buffers, np.float32(cfg.t_min),
                              t_max, active=active)
        return hit.prim >= 0

    step_pk = jax.jit(make_render_step(
        cfg, cornell_buffers,
        trace_payload_fn=payload_trace(cornell_buffers, t_min=cfg.t_min),
        occlusion_fn=occluded))
    step_jnp = jax.jit(make_render_step(cfg, cornell_buffers))
    a = np.asarray(step_pk(init_state(8, 16)).accum)
    b = np.asarray(step_jnp(init_state(8, 16)).accum)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
