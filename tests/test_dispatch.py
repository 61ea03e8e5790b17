"""Backend/traversal dispatch resolution logic."""

import dataclasses

import jax
import numpy as np
import pytest

from sfvp_tpu import RenderConfig, upload
from sfvp_tpu.config import CameraConfig
from sfvp_tpu.dispatch import _resolve, select_render_step, select_trace_fn
from sfvp_tpu.kernels.intersect import trace_brute_jnp
from sfvp_tpu.scene.buffers import from_arrays
from sfvp_tpu.scene.textures import TextureTable


def _buffers(n, mat_type=None):
    g = np.random.default_rng(0)
    tris = (g.uniform(-5, 5, (n, 1, 3)) + g.normal(0, 0.5, (n, 3, 3))).astype(
        np.float32
    )
    z = np.zeros((n, 3), np.float32)
    if mat_type is None:
        return from_arrays(tris, z, z)
    mt = np.zeros((n,), np.int32)
    mt[:2] = mat_type
    return from_arrays(tris, z, z, specular=z + 0.5, mat_type=mt,
                       rough=np.full(n, 0.3, np.float32))


def test_resolve_auto_small_scene(cornell_buffers):
    backend, traversal = _resolve(RenderConfig(), cornell_buffers)
    assert traversal == "brute"
    assert backend == "jnp"  # tests run on CPU


def test_resolve_auto_big_scene():
    backend, traversal = _resolve(RenderConfig(), _buffers(1000))
    assert traversal == "bvh"


def test_resolve_explicit_overrides(cornell_buffers, monkeypatch):
    """An explicit traversal is honoured; an explicit pallas backend is
    honoured where the kernel can run and refused where it cannot."""
    assert _resolve(RenderConfig(backend="jnp", traversal="bvh"),
                    cornell_buffers) == ("jnp", "bvh")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _resolve(RenderConfig(backend="pallas"),
                    cornell_buffers) == ("pallas", "brute")
    with pytest.raises(ValueError, match="BVH traversal"):
        _resolve(RenderConfig(backend="pallas", traversal="bvh"),
                 cornell_buffers)


def test_trace_fn_small_is_brute(cornell_buffers):
    assert select_trace_fn(RenderConfig(), cornell_buffers) is trace_brute_jnp


def test_render_step_builds_for_all_paths(cornell_buffers):
    # jnp brute
    assert callable(select_render_step(RenderConfig(backend="jnp"),
                                       cornell_buffers))
    # jnp bvh
    assert callable(
        select_render_step(
            RenderConfig(backend="jnp", traversal="bvh"), cornell_buffers
        )
    )
    # explicit trace_fn pins the jnp integrator
    assert callable(
        select_render_step(
            RenderConfig(), cornell_buffers, trace_fn=trace_brute_jnp
        )
    )


def test_nee_routes_to_jnp(cornell_buffers, monkeypatch):
    """NEE is outside the fused kernel's set: auto takes jnp even on a
    GPU, and an explicit pallas request raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = RenderConfig(use_nee=True, sampling="cosine")
    step = select_render_step(cfg, cornell_buffers)
    assert step.__module__ == "sfvp_tpu.integrate.wavefront"
    with pytest.raises(ValueError, match="next-event estimation"):
        select_render_step(dataclasses.replace(cfg, backend="pallas"),
                           cornell_buffers)


def _env_buffers(buffers):
    n = 4 * 8
    return buffers._replace(env=TextureTable(
        tr=np.ones((n,), np.float32), tg=np.ones((n,), np.float32),
        tb=np.ones((n,), np.float32), off=np.zeros((1,), np.int32),
        width=np.full((1,), 8, np.int32), height=np.full((1,), 4, np.int32),
    ))


def _textured_buffers(tmp_path):
    from sfvp_tpu import load_obj
    from sfvp_tpu.render.png import encode_png

    scene = load_obj()
    t = scene.num_triangles
    p = tmp_path / "checker.png"
    p.write_bytes(encode_png(np.full((4, 4, 3), 200, np.uint8)))
    scene.face_uv = np.zeros((t, 3, 2), np.float32)
    scene.face_tex = np.zeros((t,), np.int32)
    scene.texture_paths = [str(p)]
    return upload(scene)


def _instanced_flat():
    from sfvp_tpu.dispatch import select_instanced_render_step
    from sfvp_tpu.scene.procedural import instanced_field

    _, flat = select_instanced_render_step(
        RenderConfig(width=8, height=8), instanced_field(n_tris=600,
                                                         n_inst=4))
    return flat


_DOF = CameraConfig(lens_radius=0.1, focus_dist=3.0)

# (case id, config overrides, scene builder, expected integrator module)
_GPU_ROUTES = [
    ("parity_cornell", {}, "cornell", "sfvp_tpu.kernels.megakernel"),
    ("cosine_rr_cornell", dict(sampling="cosine", use_rr=True), "cornell",
     "sfvp_tpu.kernels.megakernel"),
    ("mirror", {}, "mirror", "sfvp_tpu.kernels.megakernel"),
    ("nee", dict(use_nee=True), "cornell", "sfvp_tpu.integrate.wavefront"),
    ("mis", dict(use_nee=True, use_mis=True), "cornell",
     "sfvp_tpu.integrate.wavefront"),
    ("dof", dict(camera=_DOF), "cornell", "sfvp_tpu.integrate.wavefront"),
    ("ggx", {}, "ggx", "sfvp_tpu.integrate.wavefront"),
    ("dielectric", {}, "dielectric", "sfvp_tpu.integrate.wavefront"),
    ("env", {}, "env", "sfvp_tpu.integrate.wavefront"),
    ("texture", {}, "texture", "sfvp_tpu.integrate.wavefront"),
    ("bvh_size", {}, "bvh", "sfvp_tpu.integrate.wavefront"),
    ("instanced", {}, "instanced", "sfvp_tpu.integrate.wavefront"),
]


def _scene(kind, cornell_buffers, tmp_path):
    if kind == "cornell":
        return cornell_buffers
    if kind == "mirror":
        return _buffers(16, mat_type=1)
    if kind == "ggx":
        return _buffers(16, mat_type=2)
    if kind == "dielectric":
        return _buffers(16, mat_type=3)
    if kind == "env":
        return _env_buffers(cornell_buffers)
    if kind == "texture":
        return _textured_buffers(tmp_path)
    if kind == "bvh":
        return _buffers(1000)
    return _instanced_flat()


@pytest.mark.parametrize("case,overrides,kind,module", _GPU_ROUTES,
                         ids=[r[0] for r in _GPU_ROUTES])
def test_gpu_dispatch(case, overrides, kind, module, cornell_buffers,
                      tmp_path, monkeypatch):
    """With the platform read as "gpu", auto takes the fused kernel exactly
    for brute-size diffuse/mirror configs without NEE, DOF, env or
    textures; everything else takes the jnp integrator, and an explicit
    backend="pallas" outside that set raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    buffers = _scene(kind, cornell_buffers, tmp_path)
    cfg = RenderConfig(width=8, height=8, spp_per_step=1, **overrides)
    assert select_render_step(cfg, buffers).__module__ == module
    pallas = dataclasses.replace(cfg, backend="pallas")
    if module == "sfvp_tpu.kernels.megakernel":
        assert select_render_step(pallas, buffers).__module__ == module
    else:
        with pytest.raises(ValueError, match="backend='pallas'"):
            select_render_step(pallas, buffers)


def test_auto_on_cpu_is_jnp_and_pallas_raises(cornell_buffers):
    """Off the GPU, auto never picks the kernel and an explicit pallas
    request raises instead of running the interpreter."""
    step = select_render_step(RenderConfig(width=8, height=8),
                              cornell_buffers)
    assert step.__module__ == "sfvp_tpu.integrate.wavefront"
    with pytest.raises(ValueError, match="platform 'cpu'"):
        select_render_step(RenderConfig(width=8, height=8, backend="pallas"),
                           cornell_buffers)


def test_unknown_backend_raises(cornell_buffers):
    with pytest.raises(ValueError, match="unknown backend"):
        select_render_step(RenderConfig(backend="tensorcore"),
                           cornell_buffers)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_bad_spp_chunk_raises_on_every_route(platform, cornell_buffers,
                                             monkeypatch):
    """spp_per_step not divisible by spp_chunk is refused whichever
    integrator dispatch picks (jnp on the CPU, the fused kernel on a GPU),
    so whether a config is accepted does not depend on the platform."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    cfg = RenderConfig(width=8, height=8, spp_per_step=5, spp_chunk=2)
    assert _resolve(cfg, cornell_buffers)[0] == (
        "pallas" if platform == "gpu" else "jnp")
    with pytest.raises(ValueError, match="divisible by spp_chunk"):
        select_render_step(cfg, cornell_buffers)


def test_spp_chunk_is_not_image_affecting_in_hash():
    """config_hash does not depend on spp_chunk; default-chunk hashes are
    bit-stable vs v1 (test_mis pins the literal)."""
    base = RenderConfig()
    chunked = dataclasses.replace(base, spp_chunk=8)
    assert base.config_hash() == chunked.config_hash()


def test_dispatch_debug_names_the_route(cornell_buffers, capfd, monkeypatch):
    monkeypatch.setenv("SFVP_DISPATCH_DEBUG", "1")
    select_render_step(RenderConfig(width=8, height=8), cornell_buffers)
    assert "wavefront(jnp) traversal=brute" in capfd.readouterr().err
