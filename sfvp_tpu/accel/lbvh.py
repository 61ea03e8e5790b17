"""Software LBVH — this renderer's replacement for the reference's hardware
acceleration structures (BLAS/TLAS built by buildAccelerationStructuresKHR,
ref main.cpp:414-538, consumed opaquely by traceRayEXT).

Build: Morton-code sort + top-down split at the highest differing bit
(LBVH topology a la Karras 2012), collapsed to <=leaf_size leaves, then
flattened in DFS order with *skip links* ("threaded" BVH). The threaded
layout needs NO per-ray stack: traversal is a single loop with one node
pointer per ray —

    node = 0
    while node != END:
        if ray hits node's AABB (closer than best t):
            leaf     -> test its triangles; node = skip[node]
            internal -> node = node + 1          # first child in DFS order
        else:
            node = skip[node]                    # jump over the subtree

which is exactly the shape a lockstep vector machine wants: no divergent
stacks, just a per-lane integer pointer.

The default build runs on host NumPy (the reference also builds on a
one-time submit path, main.cpp:440-447); a native C++ builder and an
on-device refit are layered on top (see csrc/, accel/refit.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class BVH(NamedTuple):
    """Flattened threaded BVH + morton-sorted triangle SoA (all device-ready
    numpy/jnp arrays; END sentinel == num_nodes)."""

    # nodes (M,)
    bmin_x: np.ndarray
    bmin_y: np.ndarray
    bmin_z: np.ndarray
    bmax_x: np.ndarray
    bmax_y: np.ndarray
    bmax_z: np.ndarray
    skip: np.ndarray    # i32: node to jump to on box-miss / after a leaf
    first: np.ndarray   # i32: first sorted-tri index (leaves), -1 internal
    count: np.ndarray   # i32: triangle count (0 for internal nodes)
    # sorted triangles (Ts,): geometry SoA + original primitive id
    tv: tuple           # 9 arrays: v0x v0y v0z v1x v1y v1z v2x v2y v2z
    prim_id: np.ndarray  # i32 original triangle index (for materials/parity)

    @property
    def num_nodes(self) -> int:
        return int(self.skip.shape[0])

    @property
    def leaf_size(self) -> int:
        return int(self.count.max()) if self.count.size else 0


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit morton codes (uint32)."""

    def expand(v):
        v = v.astype(np.uint32) & np.uint32(0x3FF)
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v

    return (expand(x) << 2) | (expand(y) << 1) | expand(z)


def _morton_codes(centroids: np.ndarray) -> np.ndarray:
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-9)
    q = np.clip(((centroids - lo) / extent) * 1023.0, 0, 1023).astype(np.uint32)
    return morton3d(q[:, 0], q[:, 1], q[:, 2])


def _split_position(codes: np.ndarray, lo: int, hi: int) -> int:
    """Split [lo, hi) after the highest bit where the sorted codes differ
    (LBVH criterion); falls back to the median for equal codes."""
    first, last = int(codes[lo]), int(codes[hi - 1])
    if first == last:
        return (lo + hi) // 2
    diff = first ^ last
    split_bit = diff.bit_length() - 1
    # first index whose bit `split_bit` is 1 (codes sorted => contiguous)
    prefix = first & ~((1 << (split_bit + 1)) - 1)
    target = np.uint32(prefix | (1 << split_bit))
    idx = int(np.searchsorted(codes[lo:hi], target, side="left")) + lo
    if idx <= lo or idx >= hi:
        idx = (lo + hi) // 2
    return idx


def emit_topology(codes_sorted: np.ndarray, t: int, leaf_size: int):
    """Sequential hierarchy emission from sorted morton codes (host) —
    the one inherently serial step of an LBVH build. Returns the DFS node
    table (M, 4): [lo, hi, left_child, right_child], children -1 at leaves.

    Top-down with an explicit stack (no recursion-depth limits on
    degenerate morton ladders), emitting nodes in DFS order: a node's left
    subtree immediately follows it, so `descend == node+1` and the skip
    link is just the index past the subtree."""
    nodes = []
    stack = [(0, t, -1, 0)]  # (lo, hi, parent, which_child)
    while stack:
        lo_i, hi_i, parent, which = stack.pop()
        idx = len(nodes)
        nodes.append([lo_i, hi_i, -1, -1])
        if parent >= 0:
            nodes[parent][2 + which] = idx
        if hi_i - lo_i > leaf_size:
            mid = _split_position(codes_sorted, lo_i, hi_i)
            # push right first so the left child is emitted first (DFS)
            stack.append((mid, hi_i, idx, 1))
            stack.append((lo_i, mid, idx, 0))
    return np.asarray(nodes, np.int64)


def topology_to_links(arr: np.ndarray):
    """(M, 4) node table -> (skip, first, count, is_leaf) threaded links."""
    m = arr.shape[0]
    subtree_end = np.zeros(m, np.int64)
    for i in range(m - 1, -1, -1):
        l, r = arr[i, 2], arr[i, 3]
        subtree_end[i] = i + 1 if l < 0 else subtree_end[r]
    is_leaf = arr[:, 2] < 0
    skip = subtree_end.astype(np.int32)
    first = np.where(is_leaf, arr[:, 0], -1).astype(np.int32)
    count = np.where(is_leaf, arr[:, 1] - arr[:, 0], 0).astype(np.int32)
    return skip, first, count, is_leaf


def bvh_from_arrays(
    tris: np.ndarray, leaf_size: int = 4, prim_ids: Optional[np.ndarray] = None
) -> BVH:
    """Build a threaded LBVH over (T, 3, 3) triangles (host NumPy)."""
    tris = np.asarray(tris, np.float32)
    t = tris.shape[0]
    if t == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    if prim_ids is None:
        prim_ids = np.arange(t, dtype=np.int32)

    tri_min = tris.min(axis=1)  # (T, 3)
    tri_max = tris.max(axis=1)
    centroids = 0.5 * (tri_min + tri_max)
    codes = _morton_codes(centroids)
    order = np.argsort(codes, kind="stable").astype(np.int32)
    codes_sorted = codes[order]
    tmin_s = tri_min[order]
    tmax_s = tri_max[order]

    arr = emit_topology(codes_sorted, t, leaf_size)
    m = arr.shape[0]

    skip, first, count, is_leaf = topology_to_links(arr)
    lo = arr[:, 0]
    hi = arr[:, 1]

    # node AABBs: leaves from their triangle range; internals from children
    bmin = np.zeros((m, 3), np.float32)
    bmax = np.zeros((m, 3), np.float32)
    for i in range(m - 1, -1, -1):
        if is_leaf[i]:
            bmin[i] = tmin_s[lo[i] : hi[i]].min(axis=0)
            bmax[i] = tmax_s[lo[i] : hi[i]].max(axis=0)
        else:
            l, r = arr[i, 2], arr[i, 3]
            bmin[i] = np.minimum(bmin[l], bmin[r])
            bmax[i] = np.maximum(bmax[l], bmax[r])

    tris_sorted = tris[order]
    tv = tuple(
        np.ascontiguousarray(tris_sorted[:, c, a])
        for c in range(3)
        for a in range(3)
    )

    return BVH(
        bmin_x=bmin[:, 0],
        bmin_y=bmin[:, 1],
        bmin_z=bmin[:, 2],
        bmax_x=bmax[:, 0],
        bmax_y=bmax[:, 1],
        bmax_z=bmax[:, 2],
        skip=skip,
        first=first,
        count=count,
        tv=tv,
        prim_id=prim_ids[order].astype(np.int32),
    )


def build_bvh(scene_buffers, leaf_size: int = 4, native: str = "auto") -> BVH:
    """Build from SceneBuffers (uses only the real, unpadded triangles).

    Prefers the C++ builder (csrc/, ~13x faster at 500k tris) when built;
    its output is bit-identical to the NumPy builder (tested)."""
    t = scene_buffers.num_tris
    # stack on HOST from the SoA columns — going through the jnp .v0/.v1/.v2
    # properties would dispatch (and compile) device ops per call
    cols = [
        np.asarray(getattr(scene_buffers, f))[:t]
        for f in ("v0x", "v0y", "v0z", "v1x", "v1y", "v1z",
                  "v2x", "v2y", "v2z")
    ]
    tris = np.stack(cols, axis=1).reshape(t, 3, 3)
    if native != "never":
        from .. import native as native_mod

        bvh = native_mod.build_lbvh_native(tris, leaf_size)
        if bvh is not None:
            return bvh
        if native == "require":
            raise RuntimeError(
                "native LBVH builder requested but csrc/libsfvp_native.so "
                "is not built (run `make -C csrc`)"
            )
    return bvh_from_arrays(tris, leaf_size=leaf_size)


# ---------------------------------------------------------------------------
# invariant checks (used by tests and debug tooling)
# ---------------------------------------------------------------------------


def check_invariants(bvh: BVH, tris: np.ndarray) -> None:
    """Raise AssertionError unless the BVH is well-formed:
    every triangle in exactly one leaf; node AABBs contain their contents;
    skip links are strictly forward and in range."""
    m = bvh.num_nodes
    assert bvh.skip.min() >= 1 and bvh.skip.max() <= m
    assert (bvh.skip > np.arange(m)).all(), "skip links must move forward"

    covered = np.zeros(tris.shape[0], bool)
    for i in range(m):
        c = int(bvh.count[i])
        if c > 0:
            f = int(bvh.first[i])
            assert not covered[f : f + c].any(), "triangle in two leaves"
            covered[f : f + c] = True
    assert covered.all(), "triangle missing from all leaves"

    # AABB containment (leaves vs sorted tris)
    tv = bvh.tv
    for i in range(m):
        c = int(bvh.count[i])
        if c == 0:
            continue
        f = int(bvh.first[i])
        sl = slice(f, f + c)
        for axis, (a0, a1, a2) in enumerate(
            [(tv[0], tv[3], tv[6]), (tv[1], tv[4], tv[7]), (tv[2], tv[5], tv[8])]
        ):
            lo = np.minimum(np.minimum(a0[sl], a1[sl]), a2[sl]).min()
            hi = np.maximum(np.maximum(a0[sl], a1[sl]), a2[sl]).max()
            assert [bvh.bmin_x, bvh.bmin_y, bvh.bmin_z][axis][i] <= lo + 1e-6
            assert [bvh.bmax_x, bvh.bmax_y, bvh.bmax_z][axis][i] >= hi - 1e-6
