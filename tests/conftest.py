"""Test harness: tests run on CPU jax with 8 virtual devices, so the
multi-device sharding logic (shard_map/psum) is exercised without a
cluster, and Pallas kernels run in interpret mode.

JAX_PLATFORMS defaults to cpu here. Tests marked ``gpu`` need a card and
skip elsewhere; run them on one with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (chip_smoke.py does).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# persistent XLA compilation cache (utils/cache.py): repeat runs of the
# suite's many small jits hit disk
from sfvp_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


# ---- fast tier ----------------------------------------------------------
# `pytest -m "not slow"` is the inner-loop tier; the full suite is the
# merge gate. Tests are marked here by measured duration (>= ~10 s alone
# on the CPU, `pytest --durations`) rather than inline decorators so the
# list is one place and easy to re-tune. Parameterized tests match by base
# name (all params share the mark). The multihost dry run spawns two
# jax.distributed processes and stays in the full suite only.
_SLOW_TESTS = {
    "test_karras_topology_equals_host_on_distinct_codes",
    "test_karras_duplicate_codes_valid",
    "test_karras_ranges_cover_tree",
    "test_karras_collapse_leaf_sizes",
    "test_device_build_valid_and_equivalent",
    "test_two_process_multihost_dryrun",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def cornell():
    from sfvp_tpu import load_obj

    return load_obj()


@pytest.fixture(scope="session")
def cornell_buffers(cornell):
    from sfvp_tpu import upload

    return upload(cornell)


@pytest.fixture()
def rng_np():
    return np.random.default_rng(1234)


@pytest.fixture()
def gpu_backend():
    """Skips the test unless jax runs on a GPU (decided here, never at
    import or collection time, so every xdist worker collects the same
    tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (jax backend is "
                    f"{jax.default_backend()!r})")


def make_payload_trace(buffers, trace_fn=None, t_min=1e-3):
    """A ``trace_payload_fn`` for make_render_step built from a jnp
    closest-hit trace plus gathers: the reference implementation of the
    integrator's payload hook. Materials are packed as accel/wide.py
    packs them (Ks in the albedo of non-diffuse surfaces, mtype +
    roughness in one float)."""
    from sfvp_tpu.accel.wide import materials_array, uv_array
    from sfvp_tpu.kernels.intersect import Payload, trace_brute_jnp

    trace_fn = trace_fn or trace_brute_jnp
    b = buffers
    mat = jnp.asarray(materials_array(b))
    uv = uv_array(b)
    uv = None if uv is None else jnp.asarray(uv)

    def trace(o, d, t_max, active=None):
        hit = trace_fn(o, d, b, np.float32(t_min), t_max, active=active)
        p = jnp.maximum(hit.prim, 0)
        m = mat[p]
        extra = {}
        if uv is not None:
            q = uv[p]
            w = 1.0 - hit.u - hit.v
            extra = dict(
                texu=q[:, 0] * w + q[:, 2] * hit.u + q[:, 4] * hit.v,
                texv=q[:, 1] * w + q[:, 3] * hit.u + q[:, 5] * hit.v,
                texid=q[:, 6].astype(jnp.int32) - 1,
            )
        return Payload(
            t=jnp.where(hit.prim >= 0, hit.t, jnp.inf), u=hit.u, v=hit.v,
            p0=(b.v0x[p], b.v0y[p], b.v0z[p]),
            p1=(b.v1x[p], b.v1y[p], b.v1z[p]),
            p2=(b.v2x[p], b.v2y[p], b.v2z[p]),
            albedo=(m[:, 0], m[:, 1], m[:, 2]),
            emission=(m[:, 3], m[:, 4], m[:, 5]),
            mtype=m[:, 6], **extra,
        )

    return trace


@pytest.fixture()
def payload_trace():
    return make_payload_trace
