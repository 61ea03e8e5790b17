"""Binned-SAH BVH builder (host NumPy) — a higher-quality alternative to the
Morton LBVH (accel/lbvh.py) for the offline/host build path.

The reference's hardware build exposes a quality hint
(``PreferFastTrace``, ref main.cpp:418) and the driver is free to build
whatever tree it likes behind ``buildAccelerationStructuresKHR``
(ref main.cpp:440-447); this module is that "prefer fast trace" build
here: full binned surface-area-heuristic sweeps (Wald 2007,
16 bins per axis) instead of Morton-bit splits. Same output format as the
LBVH (threaded DFS skip links + contiguous sorted-leaf triangle ranges) so
every consumer — the jnp traversal, the 8-wide collapse — works
unchanged.

Measured on the 100k-tri bumpy-sphere GI wave (benchmarks/sim_packets.py):
SAH cuts packet pops/ray by ~11% on incoherent bounce waves vs LBVH
(0.380 vs 0.425 pops/ray at width 1024) and raises leaf-row occupancy
from 0.66 to 0.74; the win grows on less uniformly tessellated scenes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .lbvh import BVH, topology_to_links

N_BINS = 16
_TRAVERSAL_COST = 1.0
_INTERSECT_COST = 1.0


def sah_bvh_from_arrays(
    tris: np.ndarray,
    leaf_size: int = 8,
    max_leaf: int = 8,
    prim_ids: Optional[np.ndarray] = None,
    native: str = "auto",
) -> BVH:
    """Build a threaded binary BVH over (T, 3, 3) triangles with binned SAH
    splits. ``leaf_size``: preferred leaf size (a leaf is made when SAH says
    splitting does not pay AND count <= max_leaf); ``max_leaf``: hard cap
    (the 8-wide collapse requires <= 8).

    native: "auto" uses the C++ builder (csrc/, ~20x faster at 100k tris,
    bit-identical output) when built; "never" forces NumPy; "require"
    errors if the library is missing."""
    tris = np.asarray(tris, np.float32)
    if native != "never" and prim_ids is None:
        from .. import native as native_mod

        bvh = native_mod.build_sah_native(tris, leaf_size, max_leaf)
        if bvh is not None:
            return bvh
        if native == "require":
            raise RuntimeError(
                "native SAH builder requested but csrc/libsfvp_native.so "
                "is not built or too old (run `make -C csrc`)"
            )
    t = tris.shape[0]
    if t == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    if prim_ids is None:
        prim_ids = np.arange(t, dtype=np.int32)

    tri_min = tris.min(axis=1)
    tri_max = tris.max(axis=1)
    cent = 0.5 * (tri_min + tri_max)

    order = np.arange(t, dtype=np.int64)  # permutation being built in place

    def half_area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    # DFS emission with an explicit stack; children follow their parent so
    # skip links come from topology_to_links unchanged.
    nodes = []  # rows [lo, hi, left, right]
    stack = [(0, t, -1, 0)]
    while stack:
        lo_i, hi_i, parent, which = stack.pop()
        idx = len(nodes)
        nodes.append([lo_i, hi_i, -1, -1])
        if parent >= 0:
            nodes[parent][2 + which] = idx
        n = hi_i - lo_i
        if n <= 1:
            continue
        ids = order[lo_i:hi_i]
        c = cent[ids]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] <= 0.0:
            # all centroids identical: median split (must split past max_leaf)
            if n <= max_leaf:
                continue
            mid = lo_i + n // 2
            stack.append((mid, hi_i, idx, 1))
            stack.append((lo_i, mid, idx, 0))
            continue

        # binned SAH on the widest centroid axis
        scale = N_BINS * (1.0 - 1e-6) / ext[axis]
        b = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
        np.clip(b, 0, N_BINS - 1, out=b)
        bin_cnt = np.bincount(b, minlength=N_BINS)
        bmin = np.full((N_BINS, 3), np.inf, np.float32)
        bmax = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(bmin, b, tri_min[ids])
        np.maximum.at(bmax, b, tri_max[ids])

        # left/right sweeps over the N_BINS-1 split planes
        lcnt = np.cumsum(bin_cnt)[:-1]
        rcnt = n - lcnt
        lmin = np.minimum.accumulate(bmin, axis=0)[:-1]
        lmax = np.maximum.accumulate(bmax, axis=0)[:-1]
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1][1:]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1][1:]
        cost = np.where(
            (lcnt > 0) & (rcnt > 0),
            half_area(lmin, lmax) * lcnt + half_area(rmin, rmax) * rcnt,
            np.inf,
        )
        best = int(np.argmin(cost))
        leaf_cost = _INTERSECT_COST * n
        parent_area = max(half_area(tri_min[ids].min(axis=0),
                                    tri_max[ids].max(axis=0)), 1e-30)
        split_cost = _TRAVERSAL_COST + _INTERSECT_COST * cost[best] / parent_area
        if n <= max_leaf and (n <= leaf_size or split_cost >= leaf_cost):
            continue
        go_left = b <= best
        if not go_left.any() or go_left.all():
            mid = lo_i + n // 2
            order[lo_i:hi_i] = ids[np.argsort(c[:, axis], kind="stable")]
        else:
            order[lo_i:hi_i] = np.concatenate([ids[go_left], ids[~go_left]])
            mid = lo_i + int(go_left.sum())
        stack.append((mid, hi_i, idx, 1))
        stack.append((lo_i, mid, idx, 0))

    arr = np.asarray(nodes, np.int64)
    m = arr.shape[0]
    skip, first, count, is_leaf = topology_to_links(arr)

    tmin_s = tri_min[order]
    tmax_s = tri_max[order]
    lo = arr[:, 0]
    hi = arr[:, 1]
    bmin = np.zeros((m, 3), np.float32)
    bmax = np.zeros((m, 3), np.float32)
    for i in range(m - 1, -1, -1):
        if is_leaf[i]:
            bmin[i] = tmin_s[lo[i]:hi[i]].min(axis=0)
            bmax[i] = tmax_s[lo[i]:hi[i]].max(axis=0)
        else:
            l, r = arr[i, 2], arr[i, 3]
            bmin[i] = np.minimum(bmin[l], bmin[r])
            bmax[i] = np.maximum(bmax[l], bmax[r])

    tris_sorted = tris[order]
    tv = tuple(
        np.ascontiguousarray(tris_sorted[:, c_, a_])
        for c_ in range(3)
        for a_ in range(3)
    )
    return BVH(
        bmin_x=bmin[:, 0], bmin_y=bmin[:, 1], bmin_z=bmin[:, 2],
        bmax_x=bmax[:, 0], bmax_y=bmax[:, 1], bmax_z=bmax[:, 2],
        skip=skip, first=first, count=count,
        tv=tv, prim_id=np.asarray(prim_ids)[order].astype(np.int32),
    )


def build_sah_bvh(scene_buffers, leaf_size: int = 8) -> BVH:
    """Build from SceneBuffers (real triangles only), host numpy."""
    t = scene_buffers.num_tris
    cols = [
        np.asarray(getattr(scene_buffers, f))[:t]
        for f in ("v0x", "v0y", "v0z", "v1x", "v1y", "v1z",
                  "v2x", "v2y", "v2z")
    ]
    tris = np.stack(cols, axis=1).reshape(t, 3, 3)
    return sah_bvh_from_arrays(tris, leaf_size=leaf_size)
