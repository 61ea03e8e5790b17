"""Instancing — the analog of the reference's TLAS over BLAS instances
(ref main.cpp:514-538: one instance, 3x4 transform, cull disable).

Two strategies:

1. *Flattening* (``flatten_instances``): each instance's mesh is
   transformed into world space and merged into one triangle soup over
   which a single LBVH is built. Fastest to trace; memory scales with
   instance count. The reference's single-identity-instance setup is the
   degenerate case and reproduces it exactly.

2. *Two-level tracing* (``make_instanced_trace``): one BLAS per UNIQUE
   mesh (shared across instances — the actual point of instancing), rays
   transformed into each instance's object space, closest hit selected
   across instances. Memory scales with unique meshes; trace cost scales
   with instance count (instances are unrolled — suited to few, large
   instances; a packet-level TLAS is future work).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ..scene.objload import Scene


@dataclasses.dataclass(frozen=True)
class Instance:
    """A mesh reference with a 3x4 row-major world transform
    (rotation/scale in [:, :3], translation in [:, 3]) — the same shape as
    VkTransformMatrixKHR (ref main.cpp:516-520)."""

    scene: Scene
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.hstack(
            [np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)]
        )
    )

    def __post_init__(self):
        t = np.asarray(self.transform, np.float32)
        if t.shape != (3, 4):
            raise ValueError(f"transform must be (3, 4), got {t.shape}")
        object.__setattr__(self, "transform", t)


def identity_instance(scene: Scene) -> Instance:
    """The reference's exact setup: one instance, identity transform."""
    return Instance(scene=scene)


def make_instanced_trace(instances: Sequence[Instance], leaf_size: int = 4):
    """Two-level trace over instances sharing per-mesh BLASes.

    Returns ``trace(o, d, scene, t_min, t_max, active) -> Hit`` with the
    standard trace interface. Hit.prim is the FLATTENED primitive id
    (instance-major, matching flatten_instances order) so shading tables
    built from the flattened scene line up.
    """
    import jax.numpy as jnp

    from ..kernels.bvh_traverse import make_trace_bvh_jnp
    from ..kernels.intersect import Hit, _as_v3
    from ..scene.buffers import from_arrays
    from .lbvh import bvh_from_arrays

    # one BLAS per unique mesh object
    blas_cache = {}
    entries = []  # (trace_fn, inv_rot (3,3), inv_trans (3,), prim_offset)
    prim_offset = 0
    for inst in instances:
        key = id(inst.scene)
        if key not in blas_cache:
            tris = inst.scene.triangles()
            bvh = bvh_from_arrays(tris, leaf_size=leaf_size)
            z = np.zeros((len(tris), 3), np.float32)
            blas_cache[key] = (
                make_trace_bvh_jnp(bvh), from_arrays(tris, z, z)
            )
        trace_fn, buffers = blas_cache[key]
        rot = inst.transform[:, :3]
        inv_rot = np.linalg.inv(rot).astype(np.float32)
        inv_trans = (-inv_rot @ inst.transform[:, 3]).astype(np.float32)
        entries.append((trace_fn, buffers, inv_rot, inv_trans, prim_offset))
        prim_offset += inst.scene.num_triangles

    def trace(o, d, scene, t_min, t_max, active=None) -> Hit:
        o = _as_v3(o)
        d = _as_v3(d)
        n = o[0].shape[0]
        best = Hit(
            t=jnp.full((n,), np.inf, jnp.float32),
            prim=jnp.full((n,), -1, jnp.int32),
            u=jnp.zeros((n,), jnp.float32),
            v=jnp.zeros((n,), jnp.float32),
        )
        for trace_fn, buffers, ir, it, off in entries:
            # object space: o' = iR @ o + it ; d' = iR @ d. t is preserved
            # because intersection distances are measured along d' whose
            # scaling matches the transformed geometry.
            oo = tuple(
                ir[a, 0] * o[0] + ir[a, 1] * o[1] + ir[a, 2] * o[2] + it[a]
                for a in range(3)
            )
            dd = tuple(
                ir[a, 0] * d[0] + ir[a, 1] * d[1] + ir[a, 2] * d[2]
                for a in range(3)
            )
            h = trace_fn(oo, dd, buffers, t_min, t_max, active=active)
            closer = h.t < best.t
            best = Hit(
                t=jnp.where(closer, h.t, best.t),
                prim=jnp.where(
                    closer, jnp.where(h.prim >= 0, h.prim + off, -1),
                    best.prim,
                ),
                u=jnp.where(closer, h.u, best.u),
                v=jnp.where(closer, h.v, best.v),
            )
        return best

    return trace


def flatten_instances(instances: Sequence[Instance]) -> Scene:
    """Merge instances into one world-space Scene (single-level fast path).

    Carries the FULL material surface: Kd/Ke/Ks, material type, GGX
    roughness, per-corner vt + texture ids (texture lists merged with
    offset ids), and the first env map present."""
    verts: List[np.ndarray] = []
    diff: List[np.ndarray] = []
    emis: List[np.ndarray] = []
    spec: List[np.ndarray] = []
    mtype: List[np.ndarray] = []
    rough: List[np.ndarray] = []
    uvs: List[np.ndarray] = []
    texs: List[np.ndarray] = []
    tex_paths: List[str] = []
    names: List[str] = []
    mat_ids: List[np.ndarray] = []
    name_offset = 0
    env_map = None
    for inst in instances:
        s = inst.scene
        t = s.num_triangles
        rot = inst.transform[:, :3]
        trans = inst.transform[:, 3]
        verts.append(s.vertices @ rot.T + trans)
        diff.append(s.face_diffuse)
        emis.append(s.face_emission)
        spec.append(
            s.face_specular
            if s.face_specular is not None
            else np.zeros_like(s.face_diffuse)
        )
        mtype.append(
            s.face_mat_type
            if s.face_mat_type is not None
            else np.zeros(t, np.int32)
        )
        rough.append(
            s.face_rough
            if getattr(s, "face_rough", None) is not None
            else np.zeros(t, np.float32)
        )
        uvs.append(
            s.face_uv
            if getattr(s, "face_uv", None) is not None
            else np.zeros((t, 3, 2), np.float32)
        )
        ftex = (
            s.face_tex
            if getattr(s, "face_tex", None) is not None
            else np.full(t, -1, np.int32)
        )
        texs.append(
            np.where(ftex >= 0, ftex + len(tex_paths), -1).astype(np.int32)
        )
        tex_paths.extend(getattr(s, "texture_paths", None) or [])
        if env_map is None:
            env_map = getattr(s, "env_map", None)
        names.extend(s.material_names)
        ids = (
            s.face_material_id
            if s.face_material_id is not None
            else np.full(t, -1, np.int32)
        )
        mat_ids.append(
            np.where(ids >= 0, ids + name_offset, -1).astype(np.int32)
        )
        name_offset += len(s.material_names)

    nv = np.concatenate(verts).astype(np.float32)
    return Scene(
        vertices=nv,
        indices=np.arange(len(nv), dtype=np.uint32),
        face_diffuse=np.concatenate(diff).astype(np.float32),
        face_emission=np.concatenate(emis).astype(np.float32),
        face_specular=np.concatenate(spec).astype(np.float32),
        face_mat_type=np.concatenate(mtype).astype(np.int32),
        face_rough=np.concatenate(rough).astype(np.float32),
        face_uv=np.concatenate(uvs).astype(np.float32),
        face_tex=np.concatenate(texs).astype(np.int32),
        texture_paths=tex_paths,
        env_map=env_map,
        material_names=names,
        face_material_id=np.concatenate(mat_ids),
    )
