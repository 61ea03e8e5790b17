"""Fused Cornell path-tracing kernel for NVIDIA Hopper (Pallas, Triton route).

One kernel launch renders a whole progressive step. A program owns
``BLOCK`` consecutive pixels, one pixel per lane. Each lane runs every
sample of the step back to back: primary ray (camera + PCG jitter), the
bounce loop with masked lanes (up to ``max_depth``, left as soon as no
path of the block is alive), a brute-force closest-hit
loop over all triangles, diffuse/mirror shading, uniform or cosine
hemisphere sampling and optional Russian roulette. Path state stays in
registers. Each bounce reads the triangle table from global memory
(20 x Tp f32, a few KB that stay in L1), and the step ends with one
read-modify-write of the running-mean accumulator per pixel.

The estimator, the sample streams and the op order are those of the jnp
wavefront integrator (integrate/wavefront.py), which is this kernel's
reference: the camera, sampling, RNG and Moller-Trumbore helpers are the
same functions. The reference's fused path is the same loop
(ref shaders/raygen.rgen:41-91, closesthit.rchit:50-65, miss.rmiss:8-12).

Capability set: diffuse and mirror materials, uniform or cosine sampling,
Russian roulette, ``row0`` row offsets for sharding. ``unsupported``
names what falls outside it; dispatch routes such configs to jnp.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import rng
from ..camera import generate_rays_soa
from ..config import RenderConfig
from ..sampling import sample_direction_cosine_soa, sample_direction_uniform_soa
from ..utils import vec
from .intersect import moller_trumbore_soa

TWO_PI = np.float32(2.0 * np.pi)
INV_PI = np.float32(1.0 / np.pi)

# Pixels per program and warps per program: the fastest of the sweep on
# the H100 at the reference workload (1024^2, 32 spp, depth 8; PERF.md).
# Small blocks leave the bounce loop sooner (the loop runs until the
# block's longest path ends).
BLOCK = 128
NUM_WARPS = 2

# scene_table rows
_V0, _V1, _V2, _KD, _KE, _KS, _MTYPE = 0, 3, 6, 9, 12, 15, 18


def scene_table(scene_buffers) -> jnp.ndarray:
    """(20, Tp) f32 triangle table: rows 0-8 vertex coords, 9-11 Kd,
    12-14 Ke, 15-17 Ks, 18 material type (as f32), 19 roughness."""
    b = scene_buffers
    return jnp.stack([
        b.v0x, b.v0y, b.v0z, b.v1x, b.v1y, b.v1z, b.v2x, b.v2y, b.v2z,
        b.dr, b.dg, b.db, b.er, b.eg, b.eb, b.sr, b.sg, b.sb,
        b.mtype.astype(jnp.float32), b.rough,
    ], axis=0)


def unsupported(cfg: RenderConfig, scene_buffers) -> List[str]:
    """Features of (cfg, scene) outside this kernel's capability set;
    empty when the kernel can render the config."""
    t = scene_buffers.num_tris
    mtype = np.asarray(scene_buffers.mtype)[:t]
    out = []
    if cfg.use_nee:
        out.append("next-event estimation")
    if cfg.camera.lens_radius > 0.0:
        out.append("thin-lens depth of field")
    if np.any(mtype == 2):
        out.append("GGX glossy material")
    if np.any(mtype == 3):
        out.append("dielectric material")
    if scene_buffers.has_textures:
        out.append("textures")
    if getattr(scene_buffers, "env", None) is not None:
        out.append("environment map")
    return out


def make_render_step_gpu(
    cfg: RenderConfig,
    scene_buffers,
    global_shape: Optional[tuple] = None,
    interpret: bool = False,
):
    """Progressive render step ``render_step(state, row0=0) -> state``
    driven by the fused kernel; same signature and estimator as
    ``integrate.make_render_step``.

    Compiles for the GPU only. ``interpret=True`` runs the kernel in
    the Pallas interpreter (tests on the CPU)."""
    cfg.spp_chunks()  # rejects a bad spp_chunk, as the jnp integrator does
    problems = unsupported(cfg, scene_buffers)
    if problems:
        raise ValueError(
            "the fused Cornell kernel does not support: " + ", ".join(problems)
        )
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            f"the fused Cornell kernel compiles for the GPU only (backend "
            f"is {jax.default_backend()!r}); pass interpret=True to run it "
            f"in the Pallas interpreter"
        )
    gh, gw = global_shape if global_shape is not None else (cfg.height, cfg.width)
    spp = cfg.spp_per_step
    max_depth = cfg.max_depth
    t_min = np.float32(cfg.t_min)
    t_max = np.float32(cfg.t_max)
    sky = tuple(np.float32(s) for s in cfg.sky_emission)
    uniform = cfg.sampling == "uniform"
    use_rr = cfg.use_rr
    rr_start = cfg.rr_start_depth

    table = scene_table(scene_buffers)
    tp = int(table.shape[1])
    table = table.reshape(-1)
    num_tris = scene_buffers.num_tris
    has_mirrors = bool(
        np.any(np.asarray(scene_buffers.mtype)[:num_tris] == 1)
    )

    def make_kernel(npix, w):
        def kernel(scal_ref, tab_ref, acc_in_ref, acc_ref, segs_ref):
            pid = pl.program_id(0)
            frame = scal_ref[0]
            row0 = scal_ref[1]
            lane = pid * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
            valid = lane < npix
            px = lane % w
            py = lane // w + row0

            def col(row, prim):
                return tab_ref[row * tp + prim]

            def trace(o, d, active):
                def tri_body(i, best):
                    bt, bp, bu, bv = best
                    p0 = tuple(tab_ref[(_V0 + k) * tp + i] for k in range(3))
                    p1 = tuple(tab_ref[(_V1 + k) * tp + i] for k in range(3))
                    p2 = tuple(tab_ref[(_V2 + k) * tp + i] for k in range(3))
                    ok, t, u, v = moller_trumbore_soa(
                        o, d, p0, p1, p2, t_min, t_max)
                    closer = ok & (t < bt)
                    return (jnp.where(closer, t, bt),
                            jnp.where(closer, i, bp),
                            jnp.where(closer, u, bu),
                            jnp.where(closer, v, bv))

                zero = jnp.zeros((BLOCK,), jnp.float32)
                init = (jnp.full((BLOCK,), np.inf, jnp.float32),
                        jnp.full((BLOCK,), -1, jnp.int32), zero, zero)
                bt, bp, bu, bv = jax.lax.fori_loop(0, num_tris, tri_body, init)
                return jnp.where(active, bp, -1), bu, bv

            def depth_body(depth, carry):
                o, d, weight, seed, done, color, segs = carry
                active = jnp.logical_not(done)
                bp, bu, bv = trace(o, d, active)
                miss = bp < 0
                prim = jnp.maximum(bp, 0)
                # shading inputs, as integrate.wavefront.shade_inputs
                p0 = tuple(col(_V0 + k, prim) for k in range(3))
                p1 = tuple(col(_V1 + k, prim) for k in range(3))
                p2 = tuple(col(_V2 + k, prim) for k in range(3))
                bw = 1.0 - bu - bv
                position = vec.add(
                    vec.add(vec.scale(p0, bw), vec.scale(p1, bu)),
                    vec.scale(p2, bv))
                normal = vec.scale(
                    vec.normalize(vec.cross(vec.sub(p1, p0), vec.sub(p2, p0))),
                    np.float32(-1.0))
                diffuse = tuple(col(_KD + k, prim) for k in range(3))
                emission = tuple(col(_KE + k, prim) for k in range(3))
                emission = vec.where(miss, sky, emission)
                emit_w = active.astype(jnp.float32)
                color = vec.add(
                    color, vec.scale(vec.mul(weight, emission), emit_w))

                r1, seed = rng.rand(seed)
                r2, seed = rng.rand(seed)
                if uniform:
                    new_dir = sample_direction_uniform_soa(r1, r2, normal)
                    cos_t = vec.dot(new_dir, normal)
                    scale = vec.scale(diffuse, (INV_PI * TWO_PI) * cos_t)
                else:
                    new_dir = sample_direction_cosine_soa(r1, r2, normal)
                    scale = diffuse
                if has_mirrors:
                    is_mirror = (col(_MTYPE, prim) == 1.0) & jnp.logical_not(miss)
                    spec = tuple(col(_KS + k, prim) for k in range(3))
                    n_f = vec.where(vec.dot(d, normal) > 0,
                                    vec.scale(normal, -1.0), normal)
                    refl = vec.sub(d, vec.scale(n_f, 2.0 * vec.dot(d, n_f)))
                    new_dir = vec.where(is_mirror, refl, new_dir)
                    scale = vec.where(is_mirror, spec, scale)

                cont = active & jnp.logical_not(miss)
                if use_rr:
                    p = jnp.clip(vec.maxc(vec.mul(weight, scale)), 0.05, 0.95)
                    r_rr, seed = rng.rand(seed)
                    rr_on = depth >= rr_start
                    survive = jnp.logical_not(rr_on) | (r_rr < p)
                    scale = vec.where(rr_on, vec.scale(scale, 1.0 / p), scale)
                    cont = cont & survive

                o = vec.where(cont, position, o)
                d = vec.where(cont, new_dir, d)
                weight = vec.where(cont, vec.mul(weight, scale), weight)
                segs = segs + active.astype(jnp.int32)
                return o, d, weight, seed, jnp.logical_not(cont), color, segs

            def sample_body(s, carry):
                color_sum, segs = carry
                seed = rng.sample_seed(px, py, s, frame, spp)
                r1, seed = rng.rand(seed)
                r2, seed = rng.rand(seed)
                o, d = generate_rays_soa(px, py, r1, r2, cfg.camera, gw, gh)
                zero = jnp.zeros((BLOCK,), jnp.float32)
                one = jnp.ones((BLOCK,), jnp.float32)
                # lanes past the last pixel start (and stay) dead
                init = (o, d, (one, one, one), seed,
                        jnp.logical_not(valid), (zero, zero, zero), segs)
                # bounce until max_depth or until no lane of the block
                # has a live path: dead lanes add nothing, so leaving early
                # changes no bit of the result
                def alive(c):
                    depth, carry = c
                    live = jnp.max(jnp.logical_not(carry[4]).astype(jnp.int32))
                    return (depth < max_depth) & (live > 0)

                def bounce(c):
                    depth, carry = c
                    return depth + 1, depth_body(depth, carry)

                _, (_, _, _, _, _, color, segs) = jax.lax.while_loop(
                    alive, bounce, (jnp.int32(0), init))
                return vec.add(color_sum, color), segs

            zero = jnp.zeros((BLOCK,), jnp.float32)
            color_sum, segs = jax.lax.fori_loop(
                0, spp, sample_body,
                ((zero, zero, zero), jnp.zeros((BLOCK,), jnp.int32)))
            segs_ref[...] = segs

            f = frame.astype(jnp.float32)
            for c in range(3):
                # masked-off lanes get out-of-range indices: the GPU never
                # touches them, and the interpreter drops them
                idx = lane * 3 + c
                old = plgpu.load(acc_in_ref.at[idx], mask=valid, other=0.0)
                new = (color_sum[c] / np.float32(spp) + old * f) / (f + 1.0)
                plgpu.store(acc_ref.at[idx], new, mask=valid)

        return kernel

    from ..integrate.wavefront import RenderState

    def render_step(state: RenderState, row0=0) -> RenderState:
        h, w = state.accum.shape[0], state.accum.shape[1]
        if w != gw:
            raise ValueError(f"accumulator width {w} != image width {gw}")
        npix = h * w
        grid = pl.cdiv(npix, BLOCK)
        scal = jnp.stack([jnp.asarray(state.frame, jnp.int32),
                          jnp.asarray(row0, jnp.int32)])
        acc, segs = pl.pallas_call(
            make_kernel(npix, w),
            grid=(grid,),
            in_specs=[pl.no_block_spec, pl.no_block_spec, pl.no_block_spec],
            out_specs=[pl.no_block_spec,
                       pl.BlockSpec((BLOCK,), lambda i: (i,))],
            out_shape=[
                jax.ShapeDtypeStruct((npix * 3,), jnp.float32),
                jax.ShapeDtypeStruct((grid * BLOCK,), jnp.int32),
            ],
            input_output_aliases={2: 0},
            backend="triton",
            compiler_params=plgpu.CompilerParams(
                num_warps=NUM_WARPS, num_stages=1),
            interpret=interpret,
            name="cornell_megakernel",
        )(scal, table, state.accum.reshape(-1))
        return RenderState(
            accum=acc.reshape(h, w, 3),
            frame=state.frame + 1,
            mrays=state.mrays
            + jnp.sum(segs).astype(jnp.float32) / np.float32(1e6),
        )

    return render_step
