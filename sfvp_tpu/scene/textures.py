"""Device texture table + filtered sampling (extension — the reference has
no textures; materials are flat Kd/Ke, ref main.cpp:47-56).

Layout: all images are flattened into ONE SoA texel pool
(three (N,) channel columns) plus a per-texture (offset, width, height)
descriptor table. Sampling a batch of hits is then a handful of XLA
gathers over the pool — no per-texture control flow, any mix of sizes.
UV convention: OBJ origin is bottom-left; wrap (repeat) addressing;
bilinear filtering.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np


class TextureTable(NamedTuple):
    tr: jnp.ndarray      # (N,) f32 texel red (linear)
    tg: jnp.ndarray      # (N,) f32
    tb: jnp.ndarray      # (N,) f32
    off: jnp.ndarray     # (K,) i32 first texel of each texture
    width: jnp.ndarray   # (K,) i32
    height: jnp.ndarray  # (K,) i32

    @property
    def num_textures(self) -> int:
        return int(self.off.shape[0])


def build_texture_table(paths: List[str],
                        srgb: bool = True) -> Optional[TextureTable]:
    """Load every image and pack the SoA pool; None when paths is empty."""
    if not paths:
        return None
    from .image_io import load_image

    chans = [[], [], []]
    off, width, height = [], [], []
    total = 0
    for p in paths:
        img = load_image(p, srgb=srgb)  # (H, W, 3) f32 linear
        h, w = img.shape[:2]
        off.append(total)
        width.append(w)
        height.append(h)
        flat = img.reshape(-1, 3)
        for c in range(3):
            chans[c].append(np.ascontiguousarray(flat[:, c]))
        total += h * w
    return TextureTable(
        tr=jnp.asarray(np.concatenate(chans[0])),
        tg=jnp.asarray(np.concatenate(chans[1])),
        tb=jnp.asarray(np.concatenate(chans[2])),
        off=jnp.asarray(np.asarray(off, np.int32)),
        width=jnp.asarray(np.asarray(width, np.int32)),
        height=jnp.asarray(np.asarray(height, np.int32)),
    )


def sample_environment(table: TextureTable, d):
    """Equirectangular environment lookup for miss directions (extension —
    the reference sky is the constant (0.7, 0.6, 0.5), ref miss.rmiss:10).

    d: direction SoA tuple (unit vectors, y-up). Longitude from atan2(z, x),
    latitude from acos(y); bilinear-filtered through the texel pool (the
    environment is texture id 0 of its own single-image table)."""
    dx, dy, dz = d
    u = jnp.arctan2(dz, dx) * np.float32(0.5 / np.pi) + 0.5
    # OBJ-convention v runs bottom-up; acos(y)/pi gives 0 at +y (top),
    # so flip into the sampler's bottom-left origin. Latitude must CLAMP
    # (the sampler's repeat wrap would blend the poles together): keep v
    # inside the texel-center band so no row wrap can occur.
    v = 1.0 - jnp.arccos(jnp.clip(dy, -1.0, 1.0)) * np.float32(1.0 / np.pi)
    h = table.height[0].astype(jnp.float32)
    v = jnp.clip(v, 0.5 / h, 1.0 - 0.5 / h)
    zero_id = jnp.zeros(dx.shape, jnp.int32)
    return sample_bilinear(table, zero_id, u, v)


def sample_bilinear(table: TextureTable, tex_id, u, v):
    """Bilinear-filtered fetch, SoA over hits: (tex_id (N,) i32, u, v (N,)
    f32) -> (r, g, b). tex_id < 0 samples white (untextured)."""
    tid = jnp.maximum(tex_id, 0)
    w = table.width[tid].astype(jnp.float32)
    h = table.height[tid].astype(jnp.float32)
    wi = table.width[tid]
    hi = table.height[tid]
    base = table.off[tid]

    # wrap (repeat); OBJ v origin is bottom-left -> image row from the top
    uu = u - jnp.floor(u)
    vv = v - jnp.floor(v)
    x = uu * w - 0.5
    y = (1.0 - vv) * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0

    def wrap(i, n):
        return jnp.mod(i.astype(jnp.int32), n)

    x0i = wrap(x0, wi)
    x1i = wrap(x0 + 1, wi)
    y0i = wrap(y0, hi)
    y1i = wrap(y0 + 1, hi)

    def fetch(yi, xi):
        idx = base + yi * wi + xi
        return table.tr[idx], table.tg[idx], table.tb[idx]

    c00 = fetch(y0i, x0i)
    c10 = fetch(y0i, x1i)
    c01 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    out = tuple(
        a * w00 + b * w10 + c * w01 + d * w11
        for a, b, c, d in zip(c00, c10, c01, c11)
    )
    white = tex_id < 0
    return tuple(jnp.where(white, 1.0, o) for o in out)
