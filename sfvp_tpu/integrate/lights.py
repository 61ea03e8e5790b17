"""Area-light table for next-event estimation (NEE).

NEE is an extension over the reference integrator (which relies purely on
BSDF sampling hitting the light, ref shaders/raygen.rgen:62-84): at each
diffuse hit a point is sampled on an emissive triangle (area-weighted),
its visibility is tested with a shadow ray, and the direct contribution
f * Le * G / pdf is added. To stay unbiased, BSDF-path emission is then
only counted on camera rays and after specular bounces. Lights are treated
as double-sided, matching the reference's facing-cull-disable behavior
(ref main.cpp:525).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np


class LightTable(NamedTuple):
    v0: tuple   # 3 component arrays (L,)
    v1: tuple
    v2: tuple
    n: tuple    # unit geometric normal components (L,)
    le: tuple   # emission components (L,)
    cdf: jnp.ndarray         # (L,) area-weighted selection CDF
    total_area: float        # static
    num: int                 # static


def build_light_table(scene) -> Optional[LightTable]:
    """Collect emissive triangles from a host Scene; None if the scene has
    no area lights."""
    em = np.asarray(scene.face_emission, np.float32)
    lit = np.any(em > 0, axis=1)
    if not lit.any():
        return None
    tris = scene.triangles()[lit]  # (L, 3, 3)
    le = em[lit]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=1)
    n = cr / np.maximum(np.linalg.norm(cr, axis=1, keepdims=True), 1e-30)
    total = float(area.sum())
    cdf = np.cumsum(area) / max(total, 1e-30)

    col = lambda a, i: jnp.asarray(np.ascontiguousarray(a[:, i]))  # noqa: E731
    return LightTable(
        v0=(col(tris[:, 0], 0), col(tris[:, 0], 1), col(tris[:, 0], 2)),
        v1=(col(tris[:, 1], 0), col(tris[:, 1], 1), col(tris[:, 1], 2)),
        v2=(col(tris[:, 2], 0), col(tris[:, 2], 1), col(tris[:, 2], 2)),
        n=(col(n, 0), col(n, 1), col(n, 2)),
        le=(col(le, 0), col(le, 1), col(le, 2)),
        cdf=jnp.asarray(cdf.astype(np.float32)),
        total_area=total,
        num=int(lit.sum()),
    )


def build_light_table_from_buffers(buffers) -> Optional[LightTable]:
    """Build from SceneBuffers (device columns; converted once on host)."""
    import types

    t = buffers.num_tris
    col = lambda f: np.asarray(getattr(buffers, f))[:t]  # noqa: E731
    scene = types.SimpleNamespace(
        face_emission=np.stack([col("er"), col("eg"), col("eb")], axis=1),
        triangles=lambda: np.stack(
            [col("v0x"), col("v0y"), col("v0z"),
             col("v1x"), col("v1y"), col("v1z"),
             col("v2x"), col("v2y"), col("v2z")],
            axis=1,
        ).reshape(t, 3, 3),
    )
    return build_light_table(scene)


def sample_light(lights: LightTable, r_sel, r1, r2):
    """Area-uniform sample over all lights.

    Returns (point (3-tuple), normal (3-tuple), Le (3-tuple), pdf_area).
    pdf_area == 1/total_area (triangle chosen proportional to area).
    """
    if lights.num <= 64:
        # CDF compare-sum: cheapest for small tables (no search)
        li = jnp.sum(
            r_sel[..., None] > lights.cdf[(None,) * r_sel.ndim], axis=-1
        ).astype(jnp.int32)
    else:
        # large light counts: O(log L) vectorized CDF search
        li = jnp.searchsorted(lights.cdf, r_sel, side="right").astype(
            jnp.int32)
    li = jnp.minimum(li, lights.num - 1)

    pick = lambda t3: tuple(c[li] for c in t3)  # noqa: E731
    v0 = pick(lights.v0)
    v1 = pick(lights.v1)
    v2 = pick(lights.v2)
    n = pick(lights.n)
    le = pick(lights.le)

    # uniform barycentric (sqrt warp)
    su = jnp.sqrt(jnp.maximum(r1, 0.0))
    b0 = 1.0 - su
    b1 = su * (1.0 - r2)
    b2 = su * r2
    point = tuple(
        a * b0 + b * b1 + c * b2 for a, b, c in zip(v0, v1, v2)
    )
    pdf_area = np.float32(1.0 / max(lights.total_area, 1e-30))
    return point, n, le, pdf_area


class EnvDistribution(NamedTuple):
    """Luminance x solid-angle importance distribution over the texels of
    an equirect environment map (NEE for image-based lighting — without
    it, a small bright sun in the map converges only through lucky BSDF
    samples)."""

    cdf: jnp.ndarray       # (H*W,) texel-selection CDF
    pdf_flat: jnp.ndarray  # (H*W,) texel-selection probability
    width: int
    height: int

    def pdf_sa_at(self, ti, sin_theta):
        """Exact solid-angle density of the sampler at a direction inside
        texel ti with polar angle theta: the sampler jitters UNIFORMLY in
        (theta, phi) inside the texel, so the density is
        flat_prob / (dtheta * dphi * sin(theta_sample)) — NOT the
        texel-average pdf (which uses sin(theta_center) and biases
        low-resolution maps near the poles)."""
        inv_patch = np.float32(
            self.width * self.height / (2.0 * np.pi * np.pi)
        )
        return (
            self.pdf_flat[ti] * inv_patch
            / jnp.maximum(sin_theta, np.float32(1e-6))
        )


def _dilate3x3(lum):
    """3x3 max-dilate a (H, W) luminance/weight grid, wrapping in
    longitude and clamping at the poles: the radiance LOOKUP is bilinear,
    so cells adjacent to a bright feature can return blended-bright
    values — their pdf must be scaled to the bright neighbor or those
    samples become huge-weight outliers."""
    lum = np.max(
        [np.roll(lum, s, axis=1) for s in (-1, 0, 1)], axis=0
    )
    pad = np.pad(lum, ((1, 1), (0, 0)), mode="edge")
    return np.max([pad[:-2], pad[1:-1], pad[2:]], axis=0)


# Env maps up to this many bytes as a packed (3W, H) f32 image (512x256)
# sample from their exact per-texel CDF; larger ones from a pooled coarse
# proposal grid of at most ENV_DIST_MAX_H rows. The estimator divides by
# the proposal's own exact pdf, so any full-support proposal is unbiased;
# coarser just means slightly noisier env sampling. The rule is kept as it
# was set when these maps had to fit a kernel's on-chip memory, so that no
# image changes.
ENV_EXACT_MAX_BYTES = 2 * 1024 * 1024
ENV_DIST_MAX_H = 256


def build_env_distribution(table, max_h=None) -> EnvDistribution:
    """table: the scene's env TextureTable (one equirect image).

    max_h (optional): cap the distribution grid at (max_h, 2*max_h) by
    pooling fine texel weights into the coarse cell containing each fine
    texel's center. The sampler then importance-samples at coarse
    granularity (uniform jitter inside the coarse cell) while radiance
    is still fetched at full resolution — an unbiased proposal for large
    maps."""
    h = int(np.asarray(table.height)[0])
    w = int(np.asarray(table.width)[0])
    r = np.asarray(table.tr)[: h * w].reshape(h, w)
    g = np.asarray(table.tg)[: h * w].reshape(h, w)
    b = np.asarray(table.tb)[: h * w].reshape(h, w)
    lum = _dilate3x3(0.2126 * r + 0.7152 * g + 0.0722 * b)
    # texel solid angle: dOmega = (2pi/W)(pi/H) sin(theta_row); image row 0
    # is the top (theta ~ 0)
    theta = (np.arange(h) + 0.5) * (np.pi / h)
    d_omega = (2 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
    weight = np.maximum(lum, 1e-8) * d_omega
    if max_h is not None and (h > max_h or w > 2 * max_h):
        h2, w2 = min(h, max_h), min(w, 2 * max_h)
        # pool: each fine texel's weight lands in the coarse cell holding
        # its center (exact for non-divisible ratios too; every coarse
        # cell receives >= 1 fine center when h2 <= h and w2 <= w)
        ri = ((np.arange(h) + 0.5) * (h2 / h)).astype(np.int64)
        ci = ((np.arange(w) + 0.5) * (w2 / w)).astype(np.int64)
        pooled = np.zeros((h2, w2), weight.dtype)
        np.add.at(pooled, (ri[:, None], ci[None, :]), weight)
        # re-dilate at coarse scale (bilinear blending crosses coarse-cell
        # boundaries) and floor for full support: pdf > 0 wherever the
        # radiance can be nonzero keeps the estimator unbiased
        weight = np.maximum(_dilate3x3(pooled), pooled.sum() * 1e-12)
        h, w = h2, w2
    total = float(weight.sum())
    flat = (weight / total).reshape(-1)
    cdf = np.cumsum(flat)
    return EnvDistribution(
        cdf=jnp.asarray(cdf.astype(np.float32)),
        pdf_flat=jnp.asarray(flat.astype(np.float32)),
        width=w,
        height=h,
    )


def env_distribution_for(table) -> EnvDistribution:
    """THE proposal distribution for env NEE: the exact per-texel CDF for
    maps up to ENV_EXACT_MAX_BYTES, else the pooled coarse proposal."""
    h = int(np.asarray(table.height)[0])
    w = int(np.asarray(table.width)[0])
    if 3 * w * h * 4 <= ENV_EXACT_MAX_BYTES:
        return build_env_distribution(table)
    return build_env_distribution(table, max_h=ENV_DIST_MAX_H)


def sample_env(dist: EnvDistribution, r_sel, r1, r2):
    """Draw a world direction ~ the env importance distribution.

    Returns (direction 3-tuple, pdf_solid_angle). Directions use the same
    equirect convention as textures.sample_environment: longitude from
    atan2(z, x), image row 0 at +y."""
    ti = jnp.searchsorted(dist.cdf, r_sel, side="right").astype(jnp.int32)
    ti = jnp.minimum(ti, dist.width * dist.height - 1)
    row = ti // dist.width
    col = ti % dist.width
    # jitter within the texel
    theta = (row.astype(jnp.float32) + r1) * np.float32(np.pi / dist.height)
    # u = phi/(2pi): sample_environment maps u = atan2(z,x)/2pi + 0.5,
    # col = u * W - 0.5 (bilinear center); invert at texel granularity
    phi = (
        (col.astype(jnp.float32) + r2) * np.float32(2 * np.pi / dist.width)
        - np.float32(np.pi)
    )
    st = jnp.sin(theta)
    d = (st * jnp.cos(phi), jnp.cos(theta), st * jnp.sin(phi))
    return d, dist.pdf_sa_at(ti, st)


def env_pdf(dist: EnvDistribution, d):
    """Solid-angle pdf the sampler above assigns to direction d (for MIS
    weighting of BSDF-path sky hits)."""
    dx, dy, dz = d
    u = jnp.arctan2(dz, dx) * np.float32(0.5 / np.pi) + 0.5
    theta = jnp.arccos(jnp.clip(dy, -1.0, 1.0))
    row = jnp.clip(
        (theta * np.float32(dist.height / np.pi)).astype(jnp.int32),
        0, dist.height - 1,
    )
    col = jnp.clip(
        (u * dist.width).astype(jnp.int32) % dist.width, 0, dist.width - 1
    )
    # same exact density as sample_env (MIS weights must agree)
    return dist.pdf_sa_at(row * dist.width + col, jnp.sin(theta))
