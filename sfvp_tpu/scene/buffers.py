"""Device-side scene buffers, the analog of the reference's AccelInput
Buffers (ref main.cpp:492-494) — structure-of-arrays jnp columns (see
utils/vec.py for why SoA)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np


class SceneBuffers(NamedTuple):
    """Triangle soup + materials on device, fully SoA.

    Padded to ``pad_to`` triangles so kernels tile cleanly; padded entries
    are degenerate (all-zero) triangles that can never be hit
    (Moller-Trumbore det == 0) with zero material.
    """

    # vertex components, each (Tp,)
    v0x: jnp.ndarray
    v0y: jnp.ndarray
    v0z: jnp.ndarray
    v1x: jnp.ndarray
    v1y: jnp.ndarray
    v1z: jnp.ndarray
    v2x: jnp.ndarray
    v2y: jnp.ndarray
    v2z: jnp.ndarray
    # material columns, each (Tp,)
    dr: jnp.ndarray
    dg: jnp.ndarray
    db: jnp.ndarray
    er: jnp.ndarray
    eg: jnp.ndarray
    eb: jnp.ndarray
    # material extensions (BASELINE config 3; zero/diffuse in parity mode)
    sr: jnp.ndarray      # Ks columns (mirror tint / glossy F0)
    sg: jnp.ndarray
    sb: jnp.ndarray
    mtype: jnp.ndarray   # (Tp,) i32: 0=diffuse, 1=mirror, 2=glossy GGX,
    #                      3=smooth dielectric
    rough: jnp.ndarray   # (Tp,) f32 GGX roughness (mtype 2) or encoded
    #                      IOR (Ni-1)/4 (mtype 3)
    num_tris: int  # static: real (unpadded) triangle count
    # texture extension (None on untextured scenes): per-corner vt columns,
    # per-face texture id, and the packed texel pool (scene/textures.py)
    u0: "jnp.ndarray | None" = None
    v0t: "jnp.ndarray | None" = None
    u1: "jnp.ndarray | None" = None
    v1t: "jnp.ndarray | None" = None
    u2: "jnp.ndarray | None" = None
    v2t: "jnp.ndarray | None" = None
    tex: "jnp.ndarray | None" = None   # (Tp,) i32, -1 = untextured
    textures: "object | None" = None   # TextureTable
    env: "object | None" = None        # TextureTable (one equirect image)

    @property
    def has_textures(self) -> bool:
        return self.textures is not None

    # --- convenience AoS views (tests, BVH build, host-side tools) ---
    @property
    def v0(self):
        return jnp.stack([self.v0x, self.v0y, self.v0z], axis=-1)

    @property
    def v1(self):
        return jnp.stack([self.v1x, self.v1y, self.v1z], axis=-1)

    @property
    def v2(self):
        return jnp.stack([self.v2x, self.v2y, self.v2z], axis=-1)

    @property
    def diffuse(self):
        return jnp.stack([self.dr, self.dg, self.db], axis=-1)

    @property
    def emission(self):
        return jnp.stack([self.er, self.eg, self.eb], axis=-1)

    @property
    def specular(self):
        return jnp.stack([self.sr, self.sg, self.sb], axis=-1)

    @property
    def padded_tris(self) -> int:
        return self.v0x.shape[0]


def from_arrays(tris: np.ndarray, diffuse: np.ndarray, emission: np.ndarray,
                specular: Optional[np.ndarray] = None,
                mat_type: Optional[np.ndarray] = None,
                rough: Optional[np.ndarray] = None,
                pad_to: Optional[int] = None,
                face_uv: Optional[np.ndarray] = None,
                face_tex: Optional[np.ndarray] = None,
                textures=None, env=None) -> SceneBuffers:
    """tris: (T, 3, 3); diffuse/emission/specular: (T, 3); mat_type/rough:
    (T,)."""
    tris = np.asarray(tris, np.float32)
    diffuse = np.asarray(diffuse, np.float32)
    emission = np.asarray(emission, np.float32)
    t = tris.shape[0]
    if specular is None:
        specular = np.zeros((t, 3), np.float32)
    if mat_type is None:
        mat_type = np.zeros((t,), np.int32)
    if rough is None:
        rough = np.zeros((t,), np.float32)
    specular = np.asarray(specular, np.float32)
    mat_type = np.asarray(mat_type, np.int32)
    rough = np.asarray(rough, np.float32)
    tp = t if pad_to is None else max(pad_to, t)

    def pad(a):
        if a.shape[0] == tp:
            return a
        out = np.zeros((tp,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return out

    tris_p = pad(tris)
    dif_p = pad(diffuse)
    emi_p = pad(emission)
    spe_p = pad(specular)
    mt_p = pad(mat_type)
    rg_p = pad(rough)
    cols = []
    for corner in range(3):
        for axis in range(3):
            cols.append(jnp.asarray(np.ascontiguousarray(tris_p[:, corner, axis])))
    for arr in (dif_p, emi_p, spe_p):
        for axis in range(3):
            cols.append(jnp.asarray(np.ascontiguousarray(arr[:, axis])))
    cols.append(jnp.asarray(mt_p))
    cols.append(jnp.asarray(rg_p))
    tex_kw = {}
    if textures is not None and face_uv is not None and face_tex is not None:
        uv_p = pad(np.asarray(face_uv, np.float32))
        tex_kw = {
            "u0": jnp.asarray(np.ascontiguousarray(uv_p[:, 0, 0])),
            "v0t": jnp.asarray(np.ascontiguousarray(uv_p[:, 0, 1])),
            "u1": jnp.asarray(np.ascontiguousarray(uv_p[:, 1, 0])),
            "v1t": jnp.asarray(np.ascontiguousarray(uv_p[:, 1, 1])),
            "u2": jnp.asarray(np.ascontiguousarray(uv_p[:, 2, 0])),
            "v2t": jnp.asarray(np.ascontiguousarray(uv_p[:, 2, 1])),
            # padded faces are untextured
            "tex": jnp.asarray(
                np.pad(np.asarray(face_tex, np.int32), (0, tp - t),
                       constant_values=-1)
            ),
            "textures": textures,
        }
    if env is not None:
        tex_kw["env"] = env
    return SceneBuffers(*cols, num_tris=t, **tex_kw)


def upload(scene, pad_to: Optional[int] = None) -> SceneBuffers:
    textures = None
    tex_paths = getattr(scene, "texture_paths", None)
    face_tex = getattr(scene, "face_tex", None)
    if tex_paths and face_tex is not None and (np.asarray(face_tex) >= 0).any():
        from .textures import build_texture_table

        textures = build_texture_table(tex_paths)
    env = None
    env_path = getattr(scene, "env_map", None)
    if env_path:
        from .textures import build_texture_table

        env = build_texture_table([env_path])
    return from_arrays(
        scene.triangles(),
        scene.face_diffuse,
        scene.face_emission,
        getattr(scene, "face_specular", None),
        getattr(scene, "face_mat_type", None),
        getattr(scene, "face_rough", None),
        pad_to=pad_to,
        face_uv=getattr(scene, "face_uv", None),
        face_tex=face_tex,
        textures=textures,
        env=env,
    )
