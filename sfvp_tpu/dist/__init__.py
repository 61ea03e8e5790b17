"""Multi-device scale-out: data-parallel pixel tiles over a device mesh.

The reference is strictly single-GPU (one compute+present queue,
ref main.cpp:122-130); this package is the scale-out the reference
never had: the framebuffer is row-sharded over a 1-D
``jax.sharding.Mesh``, every device renders its own disjoint pixel tile
in GLOBAL pixel coordinates (so seeds — and therefore pixels — are
identical to the single-device render), and the only steady-state
collective is a scalar ``psum`` of the traced-segment counter. Frame
export is the single ``all-gather``-like host fetch at observation
boundaries; checkpoints are written per shard with no gather at all.
"""

from .mesh import (  # noqa: F401
    AXIS,
    DistRenderer,
    Mesh,
    default_mesh,
    make_sharded_render_step,
)
