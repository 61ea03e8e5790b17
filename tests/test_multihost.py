"""Multi-host plumbing (dist/multihost.py). A real DCN mesh needs multiple
processes; these tests pin the single-process behavior the plumbing must
preserve (no-op init, fully-addressable fast paths) and the local-slab
arithmetic used for process-local state creation."""

import numpy as np
import jax
from jax.sharding import PartitionSpec as P

from sfvp_tpu.dist import default_mesh
from sfvp_tpu.dist.multihost import fetch_global, init_distributed, make_global_array


def test_init_distributed_single_process_noop():
    assert init_distributed() is False
    # idempotent
    assert init_distributed() is False
    assert jax.process_count() == 1


def test_make_global_array_fully_addressable():
    mesh = default_mesh()
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3)
    arr = make_global_array(mesh, P("rows", None, None), x)
    assert arr.shape == (8, 4, 3)
    assert len(arr.addressable_shards) == 8
    np.testing.assert_array_equal(np.asarray(arr), x)


def test_fetch_global_fully_addressable():
    mesh = default_mesh()
    x = np.ones((8, 4), np.float32)
    arr = make_global_array(mesh, P("rows", None), x)
    np.testing.assert_array_equal(fetch_global(arr), x)


def test_dist_renderer_single_process_still_works(cornell):
    from sfvp_tpu import RenderConfig
    from sfvp_tpu.dist import DistRenderer

    cfg = RenderConfig(width=16, height=16, spp_per_step=2, max_depth=2)
    r = DistRenderer(cfg, cornell)
    r.step(1)
    img = r.image()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_two_process_multihost_dryrun():
    """REAL 2-process jax.distributed run on CPU (4 virtual devices per
    process): exercises make_array_from_process_local_data and
    process_allgather, and pins the multi-process DistRenderer image to
    the single-process render bit-for-bit (tests/multihost_worker.py)."""
    import os
    import socket
    import subprocess
    import sys

    # free port for the coordinator
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "multihost_worker.py")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(pid)
        # each worker gets its own compile cache dir: two processes racing
        # one cache directory is the kind of flake this test must not have
        env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(
            env.get("TMPDIR", "/tmp"), f"sfvp_mh_{port}_{pid}"
        )
        procs.append(subprocess.Popen(
            [sys.executable, worker], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        import pytest

        pytest.skip("multihost worker timed out (slow CI environment)")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK {pid}" in out, out
