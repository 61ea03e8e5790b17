"""SoA vec3 math: a vector field is a tuple of three same-shaped arrays.

All hot-path geometry is structure-of-arrays: x, y, z as separate (N,)
arrays, so every elementwise op reads and writes contiguous memory (an
(N, 3) array interleaves components and strides every access). These
helpers work on any broadcastable component shapes and inside both jnp
and Pallas kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

V3 = tuple  # (x, y, z)


def v3(x, y, z) -> V3:
    return (x, y, z)


def splat(scalar3, like=None) -> V3:
    """Broadcast a length-3 constant to a component tuple."""
    a, b, c = (jnp.float32(s) for s in scalar3)
    if like is not None:
        a = jnp.full_like(like, a)
        b = jnp.full_like(like, b)
        c = jnp.full_like(like, c)
    return (a, b, c)


def from_array(arr) -> V3:
    """(..., 3) -> component tuple."""
    return (arr[..., 0], arr[..., 1], arr[..., 2])


def to_array(v) -> jnp.ndarray:
    return jnp.stack(v, axis=-1)


def add(a, b) -> V3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b) -> V3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b) -> V3:
    """Elementwise (Hadamard) product."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a, s) -> V3:
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b) -> V3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def normalize(a) -> V3:
    inv = jax.lax.rsqrt(dot(a, a))
    return scale(a, inv)


def where(mask, a, b) -> V3:
    return (
        jnp.where(mask, a[0], b[0]),
        jnp.where(mask, a[1], b[1]),
        jnp.where(mask, a[2], b[2]),
    )


def maxc(a):
    """Max component."""
    return jnp.maximum(a[0], jnp.maximum(a[1], a[2]))
