"""Aux subsystems (SURVEY.md §5): refit, instancing, preview server,
diagnostics, profiling hooks."""

import json
import os
import urllib.request

import numpy as np
import jax
import pytest

from sfvp_tpu.accel.instances import Instance, flatten_instances, identity_instance
from sfvp_tpu.accel.lbvh import bvh_from_arrays, check_invariants
from sfvp_tpu.accel.refit import make_refit, refit_bvh
from sfvp_tpu.kernels.bvh_traverse import make_trace_bvh_jnp
from sfvp_tpu.kernels.intersect import trace_brute_jnp
from sfvp_tpu.scene.buffers import from_arrays
from sfvp_tpu.utils.diagnostics import check_capabilities, device_report


def _soup(n, seed=0):
    g = np.random.default_rng(seed)
    return (
        g.uniform(-5, 5, (n, 1, 3)) + g.normal(0, 0.5, (n, 3, 3))
    ).astype(np.float32)


def test_refit_matches_fresh_build_bounds():
    tris = _soup(300, seed=1)
    bvh = bvh_from_arrays(tris, leaf_size=4)
    # deform: translate + squash
    moved = tris * np.float32(0.8) + np.float32(0.3)
    tv_new = tuple(
        np.ascontiguousarray(moved[bvh.prim_id][:, c, a])
        for c in range(3)
        for a in range(3)
    )
    refitted = refit_bvh(bvh, tv_new)
    # bounds must contain contents (invariants still hold)
    check_invariants(refitted, moved)
    # root bound equals the new scene bound
    np.testing.assert_allclose(
        [refitted.bmin_x[0], refitted.bmin_y[0], refitted.bmin_z[0]],
        moved.reshape(-1, 3).min(0),
        rtol=1e-6,
    )


def test_refit_traversal_correct():
    tris = _soup(200, seed=2)
    bvh = bvh_from_arrays(tris, leaf_size=4)
    moved = (tris + np.float32(1.5)).astype(np.float32)
    tv_new = tuple(
        np.ascontiguousarray(moved[bvh.prim_id][:, c, a])
        for c in range(3)
        for a in range(3)
    )
    refitted = refit_bvh(bvh, tv_new)
    z = np.zeros((len(moved), 3), np.float32)
    buffers = from_arrays(moved, z, z)
    g = np.random.default_rng(3)
    o = np.asarray(g.uniform(-5, 7, (256, 3)), np.float32)
    d = g.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h_ref = trace_brute_jnp(o, d, buffers, 1e-3, 1e4)
    h_bvh = make_trace_bvh_jnp(refitted)(o, d, buffers, 1e-3, 1e4)
    np.testing.assert_array_equal(
        np.isinf(np.asarray(h_ref.t)), np.isinf(np.asarray(h_bvh.t))
    )
    fin = np.isfinite(np.asarray(h_ref.t))
    np.testing.assert_allclose(
        np.asarray(h_bvh.t)[fin], np.asarray(h_ref.t)[fin], rtol=1e-5
    )


def test_instances_flatten(cornell):
    t = np.hstack([np.eye(3, dtype=np.float32) * 2.0,
                   np.asarray([[1.0], [0.0], [-1.0]], np.float32)])
    merged = flatten_instances([identity_instance(cornell),
                                Instance(scene=cornell, transform=t)])
    assert merged.num_triangles == 2 * cornell.num_triangles
    # second copy scaled+translated
    np.testing.assert_allclose(
        merged.vertices[cornell.vertices.shape[0]:],
        cornell.vertices * 2.0 + np.asarray([1.0, 0.0, -1.0]),
        rtol=1e-6,
    )
    assert len(merged.material_names) == 2 * len(cornell.material_names)
    # reference parity: single identity instance == original mesh
    single = flatten_instances([identity_instance(cornell)])
    np.testing.assert_array_equal(single.vertices, cornell.vertices)


def test_instances_flatten_carries_material_surface(cornell):
    """flatten_instances must carry the FULL material surface — roughness,
    per-corner uvs, texture ids (offset per instance), texture paths, and
    env map — not just Kd/Ke (regression: these were silently dropped)."""
    from sfvp_tpu.scene.objload import Scene

    def textured(tex_paths, env=None):
        t = 2
        return Scene(
            vertices=np.zeros((3 * t, 3), np.float32),
            indices=np.arange(3 * t, dtype=np.uint32),
            face_diffuse=np.ones((t, 3), np.float32),
            face_emission=np.zeros((t, 3), np.float32),
            face_specular=np.zeros((t, 3), np.float32),
            face_mat_type=np.full(t, 2, np.int32),
            face_rough=np.full(t, 0.25, np.float32),
            face_uv=np.full((t, 3, 2), 0.5, np.float32),
            face_tex=np.asarray([0, len(tex_paths) - 1], np.int32),
            texture_paths=list(tex_paths),
            env_map=env,
        )

    a = textured(["a0.png", "a1.png"], env="sky.hdr")
    b = textured(["b0.png"])
    merged = flatten_instances(
        [identity_instance(a), identity_instance(b), identity_instance(cornell)]
    )
    assert merged.texture_paths == ["a0.png", "a1.png", "b0.png"]
    assert merged.env_map == "sky.hdr"
    # instance b's texture ids offset past instance a's two textures
    np.testing.assert_array_equal(merged.face_tex[:2], [0, 1])
    np.testing.assert_array_equal(merged.face_tex[2:4], [2, 2])
    # cornell (no textures) pads with -1 / zeros of the right shapes
    np.testing.assert_array_equal(
        merged.face_tex[4:], np.full(cornell.num_triangles, -1, np.int32)
    )
    assert merged.face_rough.shape == (merged.num_triangles,)
    np.testing.assert_allclose(merged.face_rough[:4], 0.25)
    assert merged.face_uv.shape == (merged.num_triangles, 3, 2)
    np.testing.assert_allclose(merged.face_uv[:4], 0.5)
    np.testing.assert_array_equal(merged.face_mat_type[:4], 2)


def test_two_level_instanced_trace(cornell):
    """Two-level tracing (per-mesh BLAS + ray transforms) must agree with
    brute force over the flattened world-space scene, including flattened
    primitive ids."""
    from sfvp_tpu.accel.instances import make_instanced_trace
    from sfvp_tpu.scene.buffers import from_arrays as fa

    rot = np.asarray(
        [[0.8, 0.0, 0.6], [0.0, 1.5, 0.0], [-0.6, 0.0, 0.8]], np.float32
    )  # rotation+scale
    t2 = np.hstack([rot, np.asarray([[2.5], [0.3], [-1.0]], np.float32)])
    insts = [identity_instance(cornell), Instance(scene=cornell, transform=t2)]

    merged = flatten_instances(insts)
    z = np.zeros((merged.num_triangles, 3), np.float32)
    flat_buffers = fa(merged.triangles(), z, z)

    trace2 = make_instanced_trace(insts, leaf_size=4)
    g = np.random.default_rng(5)
    o = np.asarray(g.uniform(-2, 4, (512, 3)), np.float32)
    d = g.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    h_ref = trace_brute_jnp(o, d, flat_buffers, 1e-3, 1e4)
    h_two = trace2(o, d, None, 1e-3, 1e4)
    rt, tt = np.asarray(h_ref.t), np.asarray(h_two.t)
    np.testing.assert_array_equal(np.isinf(rt), np.isinf(tt))
    fin = np.isfinite(rt)
    np.testing.assert_allclose(tt[fin], rt[fin], rtol=2e-4)
    agree = (np.asarray(h_ref.prim) == np.asarray(h_two.prim))
    assert agree.mean() > 0.99  # fp ties only


def test_two_level_instanced_render(cornell):
    """Full render through the two-level tracer == render of the flattened
    scene (same shading tables via flattened prim ids)."""
    import jax
    from sfvp_tpu import RenderConfig, init_state, make_render_step, upload
    from sfvp_tpu.accel.instances import make_instanced_trace

    insts = [identity_instance(cornell)]
    merged = flatten_instances(insts)
    buffers = upload(merged)
    cfg = RenderConfig(width=16, height=16, spp_per_step=2, max_depth=3)
    step_two = jax.jit(
        make_render_step(cfg, buffers, trace_fn=make_instanced_trace(insts))
    )
    step_flat = jax.jit(make_render_step(cfg, buffers))
    a = np.asarray(step_two(init_state(16, 16)).accum)
    b = np.asarray(step_flat(init_state(16, 16)).accum)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_instance_transform_validation(cornell):
    with pytest.raises(ValueError, match="3, 4"):
        Instance(scene=cornell, transform=np.eye(4, dtype=np.float32))


def test_preview_server_roundtrip():
    from sfvp_tpu.render.preview import PreviewServer

    pv = PreviewServer(port=0)
    try:
        img = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
        pv.update(img)
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{pv.port}/", timeout=5
        ).read()
        assert b"live preview" in page
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{pv.port}/frame.png", timeout=5
        ).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        pv.close()


def test_preview_stream_pushes_frames():
    """/stream is PUSH (multipart/x-mixed-replace): two update() calls
    must deliver two PNG parts without the client re-requesting."""
    import socket

    from sfvp_tpu.render.preview import PreviewServer

    pv = PreviewServer(port=0)
    try:
        img = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32)
        pv.update(img)
        s = socket.create_connection(("127.0.0.1", pv.port), timeout=5)
        s.sendall(b"GET /stream HTTP/1.1\r\nHost: x\r\n\r\n")
        s.settimeout(5)

        def read_until(marker, buf=b""):
            while marker not in buf:
                chunk = s.recv(65536)
                assert chunk, "stream closed early"
                buf += chunk
            return buf

        buf = read_until(b"multipart/x-mixed-replace")
        buf = read_until(b"\x89PNG\r\n\x1a\n", buf)   # first pushed part
        tail = buf.split(b"\x89PNG", 1)[1]
        pv.update(img * 0.5)                           # push a second part
        read_until(b"\x89PNG\r\n\x1a\n", tail)
        s.close()
    finally:
        pv.close()


def test_device_report_and_capabilities():
    rep = device_report()
    assert len(rep) >= 1 and "platform" in rep[0]
    check_capabilities(min_devices=1)
    with pytest.raises(RuntimeError, match="capability check failed"):
        check_capabilities(min_devices=10**6)


def test_profiling_scopes_and_timer():
    from sfvp_tpu.utils.profiling import StepTimer, named_scope

    @jax.jit
    def f(x):
        with named_scope("sfvp_test_phase"):
            return x * 2

    assert float(f(jax.numpy.asarray(2.0))) == 4.0
    timer = StepTimer()
    with timer.phase("trace"):
        pass
    assert "trace" in timer.summary()


@pytest.fixture()
def restore_cache_config():
    """Put jax's compilation-cache settings back after a test moves them."""
    from jax._src import compilation_cache as _cc

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    prev = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in prev.items():
        jax.config.update(k, v)
    _cc.reset_cache()


def test_compilation_cache_roundtrip(tmp_path, monkeypatch,
                                     restore_cache_config):
    """The persistent XLA cache must round-trip a compiled function: a
    second compile of the same HLO is served from disk (SURVEY §2 #10 —
    the analog of the reference's committed .spv shader binaries). With
    JAX_COMPILATION_CACHE_DIR set, that directory is the cache."""
    from sfvp_tpu.utils import cache as cache_mod

    cache_dir = str(tmp_path / "xla")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cache_dir)
    assert cache_mod.enable_compilation_cache() == cache_dir
    assert jax.config.jax_compilation_cache_dir == cache_dir
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    # jax pins its cache object to the FIRST directory used in the
    # process; earlier tests enable the default-dir cache, so force a
    # re-init onto tmp_path
    from jax._src import compilation_cache as _cc

    _cc.reset_cache()

    def make():
        @jax.jit
        def f(x):
            return (x * 3.0 + 1.0).sum()

        return f

    x = jax.numpy.arange(97, dtype=jax.numpy.float32)  # unlikely-cached shape
    make()(x).block_until_ready()
    entries = list(os.listdir(cache_dir))
    assert entries, "compilation cache wrote no entries"
    # a fresh trace of an identical function must hit the cache, not
    # add a new entry
    make()(x).block_until_ready()
    assert sorted(os.listdir(cache_dir)) == sorted(entries)


def test_compilation_cache_env_dir_is_the_only_dir(tmp_path, monkeypatch,
                                                   restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, the code sets no other
    directory: the in-checkout default is neither chosen nor created."""
    from sfvp_tpu.utils import cache as cache_mod

    default = tmp_path / "default_cache"
    monkeypatch.setattr(cache_mod, "DEFAULT_DIR", str(default))
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    assert cache_mod.cache_dir() == env_dir
    assert cache_mod.enable_compilation_cache() == env_dir
    assert jax.config.jax_compilation_cache_dir == env_dir
    assert not default.exists()


def test_compilation_cache_default_is_in_checkout_and_ignored(
        monkeypatch, restore_cache_config):
    """Without JAX_COMPILATION_CACHE_DIR the cache lives at a fixed path
    inside the checkout, and git ignores it (anchored pattern)."""
    from sfvp_tpu.utils import cache as cache_mod

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache_mod.cache_dir() == os.path.join(root, ".jax_cache")
    assert cache_mod.enable_compilation_cache() == cache_mod.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == cache_mod.DEFAULT_DIR
    assert os.path.isdir(cache_mod.DEFAULT_DIR)
    with open(os.path.join(root, ".gitignore")) as f:
        assert "/.jax_cache/" in f.read().split()


def test_required_platform_check(monkeypatch):
    """check_capabilities(platform=...) refuses a run whose jax backend is
    not the required one (a measurement must not fall back to the CPU)."""
    assert jax.default_backend() == "cpu"
    check_capabilities(platform="cpu")
    with pytest.raises(RuntimeError, match="platform 'gpu' required"):
        check_capabilities(platform="gpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    check_capabilities(platform="gpu")
