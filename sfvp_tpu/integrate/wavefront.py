"""Wavefront path-tracing integrator.

This is the wavefront reformulation of the reference's per-pixel
megakernel (ref shaders/raygen.rgen:41-91): instead of one GPU thread
looping over samples and bounces, a *wave* of rays (pixels x spp_chunk
samples) advances in lockstep through trace -> shade phases under
``lax.scan``; terminated lanes are masked. All ray state is SoA —
component tuples of (N,) arrays (see utils/vec.py). Everything is
static-shaped and jit-compiles to fused XLA. It is the reference the fused
Cornell kernel (kernels/megakernel.py) is tested against.

Parity-mode semantics preserved exactly (see SURVEY.md §7 quirks):
  - color += weight * emission on EVERY segment, including the miss segment
    (sky (0.7,0.6,0.5), ref shaders/miss.rmiss:10)
  - emissive hits do NOT terminate the path; only a miss (or the depth cap)
    does (ref shaders/miss.rmiss:11, closesthit.rchit never sets done)
  - uniform hemisphere sampling, weight *= brdf * cos(theta) * 2*pi
    (ref shaders/raygen.rgen:78-80)
  - hit position from barycentrics (ref shaders/closesthit.rchit:56-57),
    geometric normal = -normalize(cross(e01, e02)) (rchit:43-48)
  - progressive accumulation new = (color + old*frame)/(frame+1)
    (ref shaders/raygen.rgen:88-90) — kept in f32 here instead of the
    reference's rgba8 round-trip (intentional improvement)
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import rng
from ..camera import apply_thin_lens_soa, generate_rays_soa
from ..config import RenderConfig
from ..kernels.intersect import trace_brute_jnp
from ..sampling import (
    coordinate_system_soa,
    ggx_d,
    ggx_lambda,
    ggx_sample_vndf_local,
    ggx_vndf_pdf,
    sample_direction_cosine_soa,
    sample_direction_uniform_soa,
)
from ..utils import vec
from .lights import sample_light

TWO_PI = np.float32(2.0 * np.pi)
INV_PI = np.float32(1.0 / np.pi)


class RenderState(NamedTuple):
    accum: jnp.ndarray         # (H, W, 3) f32 running mean over steps
    frame: jnp.ndarray         # ()      i32 progressive step counter
    mrays: jnp.ndarray         # ()      f32 cumulative traced segments / 1e6


def init_state(height: int, width: int) -> RenderState:
    return RenderState(
        accum=jnp.zeros((height, width, 3), jnp.float32),
        frame=jnp.zeros((), jnp.int32),
        mrays=jnp.zeros((), jnp.float32),
    )


def shade_inputs(scene, hit):
    """Gather per-hit shading data (SoA), mirroring the closest-hit shader
    (ref shaders/closesthit.rchit:50-65) plus the material extensions."""
    prim = jnp.maximum(hit.prim, 0)
    p0 = (scene.v0x[prim], scene.v0y[prim], scene.v0z[prim])
    p1 = (scene.v1x[prim], scene.v1y[prim], scene.v1z[prim])
    p2 = (scene.v2x[prim], scene.v2y[prim], scene.v2z[prim])
    w = 1.0 - hit.u - hit.v
    position = vec.add(
        vec.add(vec.scale(p0, w), vec.scale(p1, hit.u)), vec.scale(p2, hit.v)
    )
    normal = vec.scale(
        vec.normalize(vec.cross(vec.sub(p1, p0), vec.sub(p2, p0))),
        np.float32(-1.0),
    )
    diffuse = (scene.dr[prim], scene.dg[prim], scene.db[prim])
    emission = (scene.er[prim], scene.eg[prim], scene.eb[prim])
    specular = (scene.sr[prim], scene.sg[prim], scene.sb[prim])
    mtype = scene.mtype[prim].astype(jnp.float32)
    rough = scene.rough[prim]
    if getattr(scene, "textures", None) is not None:
        # map_Kd modulation (extension): interpolate the per-corner vt with
        # the same barycentrics as the position, bilinear-fetch the texel
        from ..scene.textures import sample_bilinear

        u_hit = scene.u0[prim] * w + scene.u1[prim] * hit.u + scene.u2[prim] * hit.v
        v_hit = (scene.v0t[prim] * w + scene.v1t[prim] * hit.u
                 + scene.v2t[prim] * hit.v)
        texc = sample_bilinear(scene.textures, scene.tex[prim], u_hit, v_hit)
        diffuse = vec.mul(diffuse, texc)
    return position, normal, diffuse, emission, specular, mtype, rough


def make_render_step(
    cfg: RenderConfig,
    scene,
    trace_fn: Optional[Callable] = None,
    global_shape: Optional[tuple] = None,
    lights=None,
    trace_payload_fn: Optional[Callable] = None,
    occlusion_fn: Optional[Callable] = None,
):
    """Build ``render_step(state, row0) -> state`` for a (local) image of
    shape taken from ``state.accum``.

    ``row0`` is the global row offset of this accumulator shard (0 when
    unsharded); ``global_shape=(H, W)`` defaults to the config's — rays are
    generated in GLOBAL pixel coordinates so sharded and unsharded renders of
    the same config produce bitwise-identical pixels.

    ``lights``: LightTable for NEE; built automatically from the scene
    buffers when cfg.use_nee and not provided.

    ``trace_payload_fn(o, d, t_max, active) -> Payload`` and the optional
    any-hit ``occlusion_fn(o, d, t_max, active) -> bool`` are the hook a
    fused GPU traversal plugs into (ROADMAP speed item 3): the trace
    returns the full shade payload (kernels/intersect.py Payload), so the
    shade phase needs no gathers, and rays are re-sorted every bounce
    (direction octant, position morton, and the material when the scene
    mixes them) so neighbouring rays traverse alike. Mutually exclusive
    with trace_fn.
    """
    import numpy as _np

    if cfg.use_nee and lights is None:
        from .lights import build_light_table_from_buffers

        lights = build_light_table_from_buffers(scene)
    has_mirrors = bool(
        _np.any(_np.asarray(scene.mtype)[: scene.num_tris] == 1)
    )
    has_glossy = bool(
        _np.any(_np.asarray(scene.mtype)[: scene.num_tris] == 2)
    )
    has_diel = bool(
        _np.any(_np.asarray(scene.mtype)[: scene.num_tris] == 3)
    )
    if trace_fn is None:
        trace_fn = trace_brute_jnp
    gh, gw = global_shape if global_shape is not None else (cfg.height, cfg.width)
    spp = cfg.spp_per_step
    chunk = cfg.spp_chunk
    n_chunks = cfg.spp_chunks()
    uniform = cfg.sampling == "uniform"
    t_min = np.float32(cfg.t_min)
    t_max = np.float32(cfg.t_max)
    use_nee = cfg.use_nee and lights is not None
    # environment importance sampling: engages when NEE is requested and
    # the scene has an env map. When area lights exist too, BOTH
    # strategies run per bounce (one light sample + one env sample) —
    # sky radiance and triangle radiance are disjoint sources, so each
    # keeps its own 2-way MIS weight against BSDF sampling
    use_env_nee = (
        cfg.use_nee and getattr(scene, "env", None) is not None
    )
    env_dist = None
    if use_env_nee:
        # exact texel CDF for small maps, a pooled coarse proposal for
        # oversized ones (lights.env_distribution_for)
        from .lights import env_distribution_for

        env_dist = env_distribution_for(scene.env)
    # balance-heuristic MIS between NEE and BSDF sampling (extension; the
    # reference is BSDF-only). Lights are selected area-proportionally, so
    # the NEE pdf of ANY emissive hit point is 1/total_area in area measure.
    use_mis = cfg.use_mis and (use_nee or use_env_nee)
    inv_light_area = (
        np.float32(1.0 / max(lights.total_area, 1e-30)) if use_nee else None
    )

    use_dof = cfg.camera.lens_radius > 0.0
    use_env = getattr(scene, "env", None) is not None
    use_payload = trace_payload_fn is not None
    sort_material = use_payload and (has_mirrors or has_glossy or has_diel)
    if use_payload:
        # static scene bounds for the morton sort key
        cols = {
            f: _np.asarray(getattr(scene, f))[: scene.num_tris]
            for f in ("v0x", "v0y", "v0z", "v1x", "v1y", "v1z",
                      "v2x", "v2y", "v2z")
        }
        lo = np.asarray(
            [min(cols[f"v{c}{a}"].min() for c in range(3)) for a in "xyz"],
            np.float32,
        )
        hi = np.asarray(
            [max(cols[f"v{c}{a}"].max() for c in range(3)) for a in "xyz"],
            np.float32,
        )
        inv_extent = 1.0 / np.maximum(hi - lo, 1e-6)

    def _sort_key(o, d, done, mtype):
        """(material << 24) | (direction octant << 21) | 7-bit-per-axis
        position morton; dead rays get the max key so they compact to the
        end of the wave. The material bits implement BASELINE config 5's
        material-sorted queues: rays leaving mirror vs diffuse surfaces
        have disjoint direction structure.
        Sorting never changes the image (colors scatter back by wave
        slot)."""

        def q7(c, a):
            x = jnp.clip((c - lo[a]) * inv_extent[a], 0.0, 1.0)
            return (x * 127.0).astype(jnp.int32)

        def expand7(v):
            # interleave 7 bits with 2-bit gaps (morton, 21 bits total)
            v = (v | (v << 8)) & 0x100F00F
            v = (v | (v << 4)) & 0x10C30C3
            v = (v | (v << 2)) & 0x1249249
            return v

        morton = (
            (expand7(q7(o[0], 0)) << 2)
            | (expand7(q7(o[1], 1)) << 1)
            | expand7(q7(o[2], 2))
        )

        octant = (
            (d[0] >= 0).astype(jnp.int32) * 4
            + (d[1] >= 0).astype(jnp.int32) * 2
            + (d[2] >= 0).astype(jnp.int32)
        )
        key = (octant << 21) | morton
        if sort_material:
            key = key | (jnp.clip(mtype.astype(jnp.int32), 0, 3) << 24)
        return jnp.where(done, jnp.int32(2**30), key)

    def _shade_from_payload(pay):
        """Derive shading inputs from a trace Payload (no gathers except
        the optional texel fetch); same math as
        shade_inputs/closesthit.rchit."""
        miss = jnp.isinf(pay.t)  # noqa: F841 (returned below)
        w = 1.0 - pay.u - pay.v
        position = vec.add(
            vec.add(vec.scale(pay.p0, w), vec.scale(pay.p1, pay.u)),
            vec.scale(pay.p2, pay.v),
        )
        nrm = vec.cross(vec.sub(pay.p1, pay.p0), vec.sub(pay.p2, pay.p0))
        inv_len = jax.lax.rsqrt(jnp.maximum(vec.dot(nrm, nrm), 1e-30))
        normal = vec.scale(nrm, -inv_len)
        # Payload stores Ks in the albedo for mirrors/glossy and packs
        # mtype + roughness into one value (as accel/wide.py does)
        mtype = jnp.floor(pay.mtype)
        rough = pay.mtype - mtype
        diffuse = pay.albedo
        if pay.texid is not None and getattr(scene, "textures", None) is not None:
            # map_Kd modulation: the trace interpolated the vt at the hit
            # (Payload.texu/texv/texid), so one bilinear pool gather per
            # wave finishes the job — mirroring shade_inputs. Mirror and
            # glossy lanes are unaffected (their brdfs read ``spec``,
            # returned unmodulated below, exactly like the jnp path where
            # the modulated Kd is dead for mtype != 0).
            from ..scene.textures import sample_bilinear

            texc = sample_bilinear(
                scene.textures, pay.texid, pay.texu, pay.texv
            )
            diffuse = vec.mul(diffuse, texc)
        return (miss, position, normal, diffuse, pay.emission,
                pay.albedo, mtype, rough)

    def _shadow_occluded(position, wl, dist, shadow_q):
        if occlusion_fn is not None:
            # dedicated any-hit test (no payload carries)
            return occlusion_fn(
                position, wl, dist * np.float32(1.0 - 1e-3), active=shadow_q
            )
        if use_payload:
            sh = trace_payload_fn(
                position, wl, dist * np.float32(1.0 - 1e-3), active=shadow_q
            )
            return jnp.isfinite(sh.t)
        sh = trace_fn(
            position, wl, scene, t_min, dist * np.float32(1.0 - 1e-3),
            active=shadow_q,
        )
        return sh.prim >= 0

    def depth_body(carry, depth_idx):
        (o, d, weight, seed, done, color, segs, count_emit, pdf_prev,
         prev_mtype, pix) = carry
        if use_payload:
            # depth 0 is skipped: primary rays are coherent and all
            # alive, so the 17-array sort is pure overhead there
            def _sorted(args):
                key = _sort_key(args[0:3], args[3:6], args[13] > 0,
                                prev_mtype)
                return jax.lax.sort((key,) + args, num_keys=1)[1:]

            args = (o[0], o[1], o[2], d[0], d[1], d[2],
                    weight[0], weight[1], weight[2],
                    color[0], color[1], color[2],
                    seed, done.astype(jnp.int32),
                    count_emit.astype(jnp.int32), pdf_prev, pix)
            (ox, oy, oz, dx, dy, dz, wr, wg, wb, cr, cg, cb,
             seed_s, done_s, ce_s, pdf_s, pix) = jax.lax.cond(
                depth_idx > 0, _sorted, lambda a: a, args
            )
            o = (ox, oy, oz)
            d = (dx, dy, dz)
            weight = (wr, wg, wb)
            color = (cr, cg, cb)
            seed = seed_s
            done = done_s.astype(bool)
            count_emit = ce_s.astype(bool)
            pdf_prev = pdf_s
        active = jnp.logical_not(done)
        if use_payload:
            pay = trace_payload_fn(o, d, t_max, active=active)
            (miss, position, normal, diffuse, emission, spec, mtype,
             rough) = _shade_from_payload(pay)
            hit_t = pay.t
        else:
            hit = trace_fn(o, d, scene, t_min, t_max, active=active)
            miss = hit.prim < 0
            (position, normal, diffuse, emission, spec, mtype,
             rough) = shade_inputs(scene, hit)
            hit_t = hit.t
        is_mirror = (mtype == 1) & jnp.logical_not(miss)
        # specular lanes (delta BSDFs): skipped by NEE, emission counted
        # in full at the next hit
        is_spec = is_mirror
        if has_diel:
            is_diel = (mtype == 3) & jnp.logical_not(miss)
            is_spec = is_mirror | is_diel
        if use_env:
            # image-based sky (extension): equirect environment lookup in
            # the miss direction instead of the constant (miss.rmiss:10)
            from ..scene.textures import sample_environment

            sky_col = sample_environment(scene.env, d)
            emission = vec.where(miss, sky_col, emission)
        else:
            emission = vec.where(miss, vec.splat(cfg.sky_emission), emission)

        if has_glossy:
            # GGX glossy (extension): build the view-oriented shading frame
            # once — both NEE (light-sample eval) and the bounce (VNDF
            # sampling) use it. Geometry is double-sided, so the frame
            # normal flips toward the incoming ray.
            is_glossy = (mtype == 2) & jnp.logical_not(miss)
            wo = vec.scale(d, -1.0)
            n_g = vec.where(vec.dot(d, normal) > 0,
                            vec.scale(normal, -1.0), normal)
            tng, btg = coordinate_system_soa(n_g)
            woz = jnp.maximum(vec.dot(wo, n_g), 1e-6)
            wo_l = (vec.dot(wo, tng), vec.dot(wo, btg), woz)
            alpha_g = jnp.maximum(rough * rough, 1e-4)
            lam_o = ggx_lambda(woz, alpha_g)

            def ggx_f(coh):
                """Schlick fresnel with the Ks tint as F0."""
                m1 = 1.0 - coh
                f5 = m1 * m1
                f5 = f5 * f5 * m1
                return tuple(s + (1.0 - s) * f5 for s in spec)

            def ggx_eval(wl):
                """(f_r per channel, bsdf pdf) for a light direction."""
                wl_l = (vec.dot(wl, tng), vec.dot(wl, btg), vec.dot(wl, n_g))
                cos_i = wl_l[2]
                h = vec.add(wo_l, wl_l)
                inv_h = jax.lax.rsqrt(jnp.maximum(vec.dot(h, h), 1e-20))
                h = vec.scale(h, inv_h)
                dgg = ggx_d(h[2], alpha_g)
                g2 = 1.0 / (1.0 + lam_o + ggx_lambda(cos_i, alpha_g))
                coh = jnp.maximum(vec.dot(wo_l, h), 1e-6)
                fr = ggx_f(coh)
                denom = jnp.maximum(4.0 * woz * jnp.maximum(cos_i, 1e-6),
                                    1e-6)
                f = tuple(fc * dgg * g2 / denom for fc in fr)
                pdf = ggx_vndf_pdf(woz, h[2], alpha_g)
                return f, pdf, cos_i

        # Without NEE: emission on every segment (ref raygen.rgen:76).
        # With NEE, BSDF-path emission is counted where the light could not
        # be light-sampled (camera rays, post-specular, sky misses) — and,
        # under MIS, everywhere else with the balance-heuristic weight
        # p_bsdf / (p_bsdf + p_nee), which removes the variance cliff of
        # hard-gating without double counting.
        if use_env_nee and use_nee:
            # both strategies light-sample every bounce: sky misses carry
            # the 2-way MIS weight against the env pdf, emissive surface
            # hits against the area-light pdf (disjoint sources — each
            # pairing is its own balance heuristic vs BSDF sampling)
            if not use_mis:
                emit_w = (active & count_emit).astype(jnp.float32)
            else:
                from .lights import env_pdf

                p_env_d = env_pdf(env_dist, d)
                w_env = pdf_prev / jnp.maximum(pdf_prev + p_env_d, 1e-30)
                cos_l_hit = jnp.abs(vec.dot(d, normal))
                t_safe = jnp.where(miss, 0.0, hit_t)
                p_nee_hit = (t_safe * t_safe) * inv_light_area / jnp.maximum(
                    cos_l_hit, np.float32(1e-6)
                )
                w_bsdf = pdf_prev / jnp.maximum(pdf_prev + p_nee_hit, 1e-30)
                is_emissive = (
                    jnp.maximum(jnp.maximum(emission[0], emission[1]),
                                emission[2]) > 0
                ) & jnp.logical_not(miss)
                emit_w = jnp.where(
                    count_emit, 1.0,
                    jnp.where(miss, w_env,
                              jnp.where(is_emissive, w_bsdf, 0.0)),
                ) * active.astype(jnp.float32)
        elif use_env_nee:
            # the sky itself is light-sampled now: gate (or MIS-weight)
            # BSDF-path sky emission; surface hits keep full weight (an
            # env-only scene has no emissive triangles)
            if not use_mis:
                emit_w = (
                    active & ((count_emit) | jnp.logical_not(miss))
                ).astype(jnp.float32)
            else:
                from .lights import env_pdf

                p_env_d = env_pdf(env_dist, d)
                w_env = pdf_prev / jnp.maximum(pdf_prev + p_env_d, 1e-30)
                emit_w = jnp.where(
                    count_emit | jnp.logical_not(miss), 1.0, w_env
                ) * active.astype(jnp.float32)
        elif not use_nee:
            emit_w = active.astype(jnp.float32)
        elif not use_mis:
            emit_w = (active & (count_emit | miss)).astype(jnp.float32)
        else:
            cos_l_hit = jnp.abs(vec.dot(d, normal))
            t_safe = jnp.where(miss, 0.0, hit_t)
            p_nee_hit = (t_safe * t_safe) * inv_light_area / jnp.maximum(
                cos_l_hit, np.float32(1e-6)
            )
            w_bsdf = pdf_prev / jnp.maximum(pdf_prev + p_nee_hit, 1e-30)
            is_emissive = (
                jnp.maximum(jnp.maximum(emission[0], emission[1]), emission[2])
                > 0
            ) & jnp.logical_not(miss)
            emit_w = jnp.where(
                count_emit | miss, 1.0, jnp.where(is_emissive, w_bsdf, 0.0)
            ) * active.astype(jnp.float32)
        contrib = vec.scale(vec.mul(weight, emission), emit_w)
        color = vec.add(color, contrib)

        if use_nee:
            r_sel, seed = rng.rand(seed)
            rl1, seed = rng.rand(seed)
            rl2, seed = rng.rand(seed)
            q, nl, le, pdf_area = sample_light(lights, r_sel, rl1, rl2)
            to_l = vec.sub(q, position)
            dist2 = jnp.maximum(vec.dot(to_l, to_l), 1e-12)
            dist = jnp.sqrt(dist2)
            wl = vec.scale(to_l, 1.0 / dist)
            cos_s = vec.dot(wl, normal)
            brdf_l = vec.scale(diffuse, INV_PI)
            if has_glossy:
                f_g, pdf_g_l, cos_i_g = ggx_eval(wl)
                cos_s = jnp.where(is_glossy, cos_i_g, cos_s)
                brdf_l = vec.where(is_glossy, f_g, brdf_l)
            cos_l = jnp.abs(vec.dot(wl, nl))  # double-sided light
            shadow_q = active & jnp.logical_not(miss | is_spec) & (cos_s > 0)
            occluded = _shadow_occluded(position, wl, dist, shadow_q)
            visible = shadow_q & jnp.logical_not(occluded)
            g_over_pdf = cos_s * cos_l / (dist2 * pdf_area)
            direct = vec.scale(vec.mul(brdf_l, le), g_over_pdf)
            if use_mis:
                # balance heuristic in solid-angle measure
                p_nee_sa = dist2 * pdf_area / jnp.maximum(
                    cos_l, np.float32(1e-6)
                )
                if uniform:
                    p_bsdf_l = jnp.full_like(cos_s, 1.0 / TWO_PI)
                else:
                    p_bsdf_l = jnp.maximum(cos_s, 0.0) * INV_PI
                if has_glossy:
                    p_bsdf_l = jnp.where(is_glossy, pdf_g_l, p_bsdf_l)
                w_nee = p_nee_sa / jnp.maximum(p_nee_sa + p_bsdf_l, 1e-30)
                direct = vec.scale(direct, w_nee)
            color = vec.add(
                color,
                vec.where(visible, vec.mul(weight, direct), vec.splat((0, 0, 0))),
            )

        if use_env_nee:
            from .lights import sample_env
            from ..scene.textures import sample_environment

            r_sel, seed = rng.rand(seed)
            rl1, seed = rng.rand(seed)
            rl2, seed = rng.rand(seed)
            wl, pdf_sa = sample_env(env_dist, r_sel, rl1, rl2)
            cos_s = vec.dot(wl, normal)
            brdf_l = vec.scale(diffuse, INV_PI)
            if has_glossy:
                f_g, pdf_g_l, cos_i_g = ggx_eval(wl)
                cos_s = jnp.where(is_glossy, cos_i_g, cos_s)
                brdf_l = vec.where(is_glossy, f_g, brdf_l)
            shadow_q = active & jnp.logical_not(miss | is_spec) & (cos_s > 0)
            occluded = _shadow_occluded(
                position, wl, jnp.full_like(cos_s, t_max), shadow_q
            )
            visible = shadow_q & jnp.logical_not(occluded)
            env_le = sample_environment(scene.env, wl)
            inv_pdf = 1.0 / jnp.maximum(pdf_sa, 1e-12)
            direct = vec.scale(vec.mul(brdf_l, env_le), cos_s * inv_pdf)
            if use_mis:
                if uniform:
                    p_bsdf_l = jnp.full_like(cos_s, 1.0 / TWO_PI)
                else:
                    p_bsdf_l = jnp.maximum(cos_s, 0.0) * INV_PI
                if has_glossy:
                    p_bsdf_l = jnp.where(is_glossy, pdf_g_l, p_bsdf_l)
                direct = vec.scale(
                    direct, pdf_sa / jnp.maximum(pdf_sa + p_bsdf_l, 1e-30)
                )
            color = vec.add(
                color,
                vec.where(visible, vec.mul(weight, direct),
                          vec.splat((0, 0, 0))),
            )

        r1, seed = rng.rand(seed)
        r2, seed = rng.rand(seed)
        if uniform:
            sampled = sample_direction_uniform_soa(r1, r2, normal)
            cos_t = vec.dot(sampled, normal)
            # brdf = Kd/pi (rchit:61); weight *= brdf*cos/(1/2pi)
            scale = vec.scale(diffuse, (INV_PI * TWO_PI) * cos_t)
        else:
            sampled = sample_direction_cosine_soa(r1, r2, normal)
            # pdf = cos/pi cancels the cosine: weight *= Kd
            scale = diffuse

        glossy_kill = None
        if has_glossy:
            # GGX bounce: VNDF half-vector sample (reusing the same r1/r2
            # draws as the hemisphere sample keeps RNG streams material-
            # independent), reflect, weight = F * G2_hc / G1(wo).
            h_l = ggx_sample_vndf_local(r1, r2, wo_l, alpha_g)
            coh = jnp.maximum(vec.dot(wo_l, h_l), 1e-6)
            wi_l = vec.sub(vec.scale(h_l, 2.0 * coh), wo_l)
            g_valid = wi_l[2] > 1e-5
            wi_g = vec.add(
                vec.add(vec.scale(tng, wi_l[0]), vec.scale(btg, wi_l[1])),
                vec.scale(n_g, wi_l[2]),
            )
            g2_over_g1 = (1.0 + lam_o) / (
                1.0 + lam_o + ggx_lambda(wi_l[2], alpha_g)
            )
            scale_g = vec.scale(ggx_f(coh), g2_over_g1)
            sampled = vec.where(is_glossy, wi_g, sampled)
            scale = vec.where(is_glossy, scale_g, scale)
            # a sampled direction below the surface is absorbed (standard
            # single-scattering GGX energy loss)
            glossy_kill = is_glossy & jnp.logical_not(g_valid)

        if has_mirrors:
            # perfect mirror (extension): reflect about the normal flipped
            # toward the incoming ray (geometry is double-sided)
            n_dot_d = vec.dot(d, normal)
            n_f = vec.where(n_dot_d > 0, vec.scale(normal, -1.0), normal)
            refl = vec.sub(d, vec.scale(n_f, 2.0 * vec.dot(d, n_f)))
            new_dir = vec.where(is_mirror, refl, sampled)
            scale = vec.where(is_mirror, spec, scale)
        else:
            new_dir = sampled

        if has_diel:
            # smooth dielectric (extension): Snell refraction with the
            # exact unpolarized Fresnel split, stochastic reflect/refract
            # choice reusing the r1 draw (keeps RNG streams material-
            # independent — same pattern as the GGX VNDF reuse above).
            # The rough column carries the encoded IOR (Ni-1)/4 for
            # mtype 3 (scene/objload.py); tint is Ks. No radiance
            # eta^2 factor (camera-path radiance convention).
            from ..sampling import dielectric_reflect_refract_soa

            ior = 1.0 + 4.0 * rough
            refl_d, refr_d, fres, tir = dielectric_reflect_refract_soa(
                d, normal, ior
            )
            choose_refl = tir | (r1 < fres)
            diel_dir = vec.where(choose_refl, refl_d, refr_d)
            new_dir = vec.where(is_diel, diel_dir, new_dir)
            scale = vec.where(is_diel, spec, scale)

        cont = active & jnp.logical_not(miss)
        if glossy_kill is not None:
            cont = cont & jnp.logical_not(glossy_kill)
        if cfg.use_rr:
            # Russian roulette (extension; OFF in parity mode): from
            # rr_start_depth on, continue with probability p and compensate.
            p = jnp.clip(vec.maxc(vec.mul(weight, scale)), 0.05, 0.95)
            r_rr, seed = rng.rand(seed)
            rr_on = depth_idx >= cfg.rr_start_depth
            survive = jnp.logical_not(rr_on) | (r_rr < p)
            scale = vec.where(rr_on, vec.scale(scale, 1.0 / p), scale)
            cont = cont & survive

        o = vec.where(cont, position, o)
        d = vec.where(cont, new_dir, d)
        weight = vec.where(cont, vec.mul(weight, scale), weight)
        done = jnp.logical_not(cont)
        count_emit = (
            is_spec if (use_nee or use_env_nee) else count_emit
        )
        if use_mis:
            if uniform:
                new_pdf = jnp.full_like(pdf_prev, 1.0 / TWO_PI)
            else:
                new_pdf = jnp.maximum(vec.dot(sampled, normal), 0.0) * INV_PI
            if has_glossy:
                new_pdf = jnp.where(
                    is_glossy, ggx_vndf_pdf(woz, h_l[2], alpha_g), new_pdf
                )
            pdf_prev = jnp.where(cont, new_pdf, pdf_prev)
        segs = segs + jnp.sum(active.astype(jnp.float32))
        prev_mtype = jnp.where(cont, mtype.astype(jnp.float32), jnp.float32(0.0))
        return (o, d, weight, seed, done, color, segs, count_emit,
                pdf_prev, prev_mtype, pix), None

    def chunk_body(carry, chunk_idx, px, py, frame):
        color_sum, segs = carry
        n = px.shape[0]
        s_ids = chunk_idx * chunk + jnp.arange(chunk, dtype=jnp.uint32)
        seed = rng.sample_seed(
            px[None, :], py[None, :], s_ids[:, None], frame, spp
        )  # (C, N)
        r1, seed = rng.rand(seed)
        r2, seed = rng.rand(seed)
        pxc = jnp.broadcast_to(px[None, :], (chunk, n))
        pyc = jnp.broadcast_to(py[None, :], (chunk, n))
        o, d = generate_rays_soa(pxc, pyc, r1, r2, cfg.camera, gw, gh)
        if use_dof:
            # thin-lens DOF (extension): two extra draws, taken ONLY when
            # the lens is open so pinhole RNG streams are untouched
            rl1, seed = rng.rand(seed)
            rl2, seed = rng.rand(seed)
            o, d = apply_thin_lens_soa(o, d, rl1, rl2, cfg.camera)

        m = chunk * n
        flat = lambda t3: tuple(a.reshape(m) for a in t3)  # noqa: E731
        o = flat(o)
        d = flat(d)
        seed = seed.reshape(m)
        weight = vec.splat((1, 1, 1), like=o[0])
        done = jnp.zeros((m,), bool)
        color = vec.splat((0, 0, 0), like=o[0])
        count_emit = jnp.ones((m,), bool)
        pdf_prev = jnp.zeros((m,), jnp.float32)
        prev_mtype = jnp.zeros((m,), jnp.float32)
        pix = jnp.arange(m, dtype=jnp.int32)  # wave slot, travels with ray

        (o, d, weight, seed, done, color, segs, count_emit, pdf_prev,
         prev_mtype, pix), _ = (
            jax.lax.scan(
                depth_body,
                (o, d, weight, seed, done, color, segs, count_emit,
                 pdf_prev, prev_mtype, pix),
                jnp.arange(cfg.max_depth, dtype=jnp.int32),
            )
        )
        if use_payload:
            # rays were permuted by the per-bounce sorts; scatter colors
            # back to wave-slot order (pix is a permutation of arange(m))
            color = tuple(
                jnp.zeros((m,), jnp.float32).at[pix].set(c) for c in color
            )
        csum = tuple(c.reshape(chunk, n).sum(axis=0) for c in color)
        color_sum = vec.add(color_sum, csum)
        return (color_sum, segs), None

    def render_pixels(px, py, frame):
        """Trace cfg.spp_per_step samples for an arbitrary batch of GLOBAL
        pixel coordinates; returns (color_sum tuple of (N,), segs). The
        building block of both the full-frame step below and the adaptive
        sampler (integrate/adaptive.py)."""
        zero3 = vec.splat(
            (0, 0, 0), like=jnp.zeros(px.shape, jnp.float32)
        )
        init = (zero3, jnp.zeros((), jnp.float32))
        (color_sum, segs), _ = jax.lax.scan(
            partial(chunk_body, px=px, py=py, frame=frame),
            init,
            jnp.arange(n_chunks, dtype=jnp.uint32),
        )
        return color_sum, segs

    def render_step(state: RenderState, row0=0) -> RenderState:
        h, w = state.accum.shape[0], state.accum.shape[1]
        idx = jnp.arange(h * w, dtype=jnp.int32)
        px = idx % w
        py = idx // w + jnp.asarray(row0, jnp.int32)

        frame = state.frame
        color_sum, segs = render_pixels(px, py, frame)
        color = vec.to_array(
            tuple(c.reshape(h, w) for c in color_sum)
        ) / np.float32(spp)
        f = frame.astype(jnp.float32)
        accum = (color + state.accum * f) / (f + 1.0)
        return RenderState(
            accum=accum,
            frame=frame + 1,
            mrays=state.mrays + segs / np.float32(1e6),
        )

    render_step.render_pixels = render_pixels
    return render_step
