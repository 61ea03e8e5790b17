"""sfvp_tpu — a wavefront Monte-Carlo path tracer in JAX.

A JAX / XLA / Pallas renderer with the capabilities of
yknishidate/single-file-vulkan-pathtracing: progressive Cornell-Box path
tracing with exact reference semantics in parity mode, plus extensions
(a fused Cornell kernel for GPUs, software BVHs, multi-device sharding,
cosine sampling / NEE / Russian roulette, checkpoint-resume).
"""

from .config import CameraConfig, RenderConfig  # noqa: F401
from .scene import Scene, SceneBuffers, load_obj, upload, cornell_box_path  # noqa: F401
from .integrate import RenderState, init_state, make_render_step  # noqa: F401
from .render import Renderer, render, write_png  # noqa: F401

__version__ = "0.1.0"
