"""Ray/triangle intersection — the software replacement for the
reference's hardware ``traceRayEXT`` (ref shaders/raygen.rgen:63-75) +
BLAS/TLAS (ref main.cpp:414-538).

Semantics matched:
  - no backface culling (ref main.cpp:525 sets TriangleFacingCullDisable);
    Moller-Trumbore accepts hits with either det sign
  - opaque geometry, closest hit wins
  - valid window t in (t_min, t_max)

All hot-path math is SoA (see utils/vec.py): rays are component tuples of
(N,) arrays; hit records are SoA fields (the analog of the HitPayload
ABI, ref shaders/common.glsl:2-9).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import vec

INF = np.float32(np.inf)
_DET_EPS = np.float32(1e-12)


class Hit(NamedTuple):
    t: jnp.ndarray      # (N,) f32, +inf on miss
    prim: jnp.ndarray   # (N,) i32, -1 on miss
    u: jnp.ndarray      # (N,) f32 barycentric
    v: jnp.ndarray      # (N,) f32 barycentric


class Payload(NamedTuple):
    """Closest-hit record plus shade data, SoA over rays (miss: t == +inf).
    What a trace that resolves materials itself hands the integrator's
    ``trace_payload_fn`` hook in place of a ``Hit``."""

    t: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    p0: tuple
    p1: tuple
    p2: tuple
    albedo: tuple       # Kd for diffuse, Ks for mirror/glossy/dielectric
    emission: tuple
    mtype: jnp.ndarray  # f32: material type + roughness (or encoded IOR)
    # map_Kd extension (None on untextured scenes): interpolated vt at the
    # hit + texture id; the shade phase does the bilinear fetch
    texu: "jnp.ndarray | None" = None
    texv: "jnp.ndarray | None" = None
    texid: "jnp.ndarray | None" = None  # i32, -1 = untextured


def _as_v3(a):
    """Accept either an (N, 3) array or an SoA component tuple."""
    if isinstance(a, (tuple, list)):
        return tuple(a)
    return vec.from_array(a)


def moller_trumbore_soa(o, d, p0, p1, p2, t_min, t_max):
    """SoA Moller-Trumbore, no culling. o, d, p0..p2 are component tuples
    with broadcastable shapes. Returns (valid, t, u, v)."""
    e1 = vec.sub(p1, p0)
    e2 = vec.sub(p2, p0)
    pv = vec.cross(d, e2)
    det = vec.dot(e1, pv)
    inv_det = jnp.where(jnp.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    tv = vec.sub(o, p0)
    u = vec.dot(tv, pv) * inv_det
    qv = vec.cross(tv, e1)
    v = vec.dot(d, qv) * inv_det
    t = vec.dot(e2, qv) * inv_det
    valid = (
        (jnp.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return valid, t, u, v


def moller_trumbore(o, d, v0, v1, v2, t_min, t_max):
    """Array-interface wrapper: o, d (..., 3); v0/v1/v2 broadcastable."""
    return moller_trumbore_soa(
        _as_v3(o), _as_v3(d), _as_v3(v0), _as_v3(v1), _as_v3(v2), t_min, t_max
    )


def trace_brute_jnp(o, d, scene, t_min, t_max, active=None) -> Hit:
    """Closest-hit over ALL triangles via a scan over the scene's SoA
    columns (peak memory O(N_rays), not O(N_rays * N_tris)). Ideal for
    small scenes — e.g. the 36-triangle Cornell Box — and the oracle the
    fused Cornell kernel (kernels/megakernel.py) is tested against.

    o, d: component tuples of (N,) arrays (or (N, 3) arrays).
    """
    o = _as_v3(o)
    d = _as_v3(d)
    n = o[0].shape[0]
    init = (
        jnp.full((n,), INF, jnp.float32),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )

    tp = scene.v0x.shape[0]
    cols = jnp.stack(
        [scene.v0x, scene.v0y, scene.v0z,
         scene.v1x, scene.v1y, scene.v1z,
         scene.v2x, scene.v2y, scene.v2z], axis=1
    )  # (Tp, 9) — scanned row by row; each row is 9 scalars
    prim_ids = jnp.arange(tp, dtype=jnp.int32)

    def body(carry, row):
        bt, bp, bu, bv = carry
        c, pid = row
        p0 = (c[0], c[1], c[2])
        p1 = (c[3], c[4], c[5])
        p2 = (c[6], c[7], c[8])
        valid, t, u, v = moller_trumbore_soa(o, d, p0, p1, p2, t_min, t_max)
        closer = valid & (t < bt)
        bt = jnp.where(closer, t, bt)
        bp = jnp.where(closer, pid, bp)
        bu = jnp.where(closer, u, bu)
        bv = jnp.where(closer, v, bv)
        return (bt, bp, bu, bv), None

    (bt, bp, bu, bv), _ = jax.lax.scan(body, init, (cols, prim_ids))
    if active is not None:
        bt = jnp.where(active, bt, INF)
        bp = jnp.where(active, bp, -1)
    return Hit(t=bt, prim=bp, u=bu, v=bv)
