"""Instanced scenes: the flattened rendering path every driver takes for
lists of Instances."""

import numpy as np
import pytest

from sfvp_tpu.accel.instances import Instance, flatten_instances
from sfvp_tpu.scene.objload import Scene


def _lamp():
    return Instance(
        scene=Scene(
            vertices=np.asarray([
                [-1.2, 4.0, -1.2], [1.2, 4.0, -1.2], [1.2, 4.0, 1.2],
                [-1.2, 4.0, -1.2], [1.2, 4.0, 1.2], [-1.2, 4.0, 1.2],
            ], np.float32),
            indices=np.arange(6, dtype=np.uint32),
            face_diffuse=np.zeros((2, 3), np.float32),
            face_emission=np.full((2, 3), 9.0, np.float32),
        ),
        transform=np.hstack([np.eye(3, dtype=np.float32),
                             np.zeros((3, 1), np.float32)]))


def _field_cfg(**kw):
    from sfvp_tpu import RenderConfig
    from sfvp_tpu.config import CameraConfig

    cam = CameraConfig.look_at(origin=(6.0, 5.0, 6.0), target=(0, 0.6, 0),
                               fov_y_deg=50)
    base = dict(width=16, height=16, spp_per_step=2, max_depth=2,
                camera=cam, sampling="cosine", sky_emission=(0.8, 0.85, 1.0))
    base.update(kw)
    return RenderConfig(**base)


def test_instanced_renderer_first_class():
    """A list of Instances is a first-class Renderer scene: dispatch
    flattens it (dispatch.select_instanced_render_step), so it
    pixel-matches the flattened scene, with and without NEE."""
    import dataclasses

    from sfvp_tpu.render.driver import Renderer
    from sfvp_tpu.scene.procedural import instanced_field

    insts = instanced_field(n_tris=300, n_inst=4)
    cfg = _field_cfg()
    a = np.asarray(Renderer(cfg, insts).step(1).accum)
    b = np.asarray(Renderer(cfg, flatten_instances(insts)).step(1).accum)
    np.testing.assert_array_equal(a, b)

    with pytest.raises(ValueError):
        Renderer(cfg, insts, trace_fn=lambda *a: None)

    lit = insts + [_lamp()]
    cfg_nee = dataclasses.replace(cfg, use_nee=True, use_mis=True,
                                  sky_emission=(0.05, 0.05, 0.05))
    a = np.asarray(Renderer(cfg_nee, lit).step(1).accum)
    b = np.asarray(Renderer(cfg_nee, flatten_instances(lit)).step(1).accum)
    np.testing.assert_array_equal(a, b)


def test_instanced_textures_match_flattened(tmp_path):
    """map_Kd on instanced scenes: flattening merges the texture pools —
    including the duplicate entries for instances sharing one textured
    mesh — and the render pixel-matches the flattened scene."""
    from sfvp_tpu.render.driver import Renderer
    from sfvp_tpu.scene.procedural import instanced_field

    # two textures with distinct colors so a texid/base mix-up shows
    tex_r = tmp_path / "r.ppm"
    tex_r.write_bytes(b"P6 2 2 255\n" + bytes([255, 40, 40] * 4))
    tex_g = tmp_path / "g.ppm"
    tex_g.write_bytes(b"P6 2 2 255\n" + bytes([40, 255, 40] * 4))
    insts = instanced_field(n_tris=400, n_inst=4)
    # instances 1 and 3 SHARE ball_a; 2 and 4 share ball_b — texture both
    # meshes so the shared-mesh duplicate-pool-entry path is exercised
    for mesh, tex in ((insts[1].scene, tex_r), (insts[2].scene, tex_g)):
        n = mesh.num_triangles
        tri = mesh.vertices[mesh.indices.reshape(-1)].reshape(n, 3, 3)
        mesh.face_uv = np.stack(
            [tri[..., 0] * 0.5 + 0.5, tri[..., 2] * 0.5 + 0.5], axis=-1
        ).astype(np.float32)
        mesh.face_tex = np.zeros((n,), np.int32)
        mesh.texture_paths = [str(tex)]
    cfg = _field_cfg()
    a = np.asarray(Renderer(cfg, insts).step(1).accum)
    b = np.asarray(Renderer(cfg, flatten_instances(insts)).step(1).accum)
    np.testing.assert_array_equal(a, b)
    # the textures must actually have fired
    assert a.max() > 0.05


def test_adaptive_instanced_warmup_matches_flattened():
    """AdaptiveRenderer accepts instance lists (flattened); a uniform
    warmup step matches the flattened scene exactly."""
    from sfvp_tpu.integrate.adaptive import AdaptiveRenderer
    from sfvp_tpu.scene.procedural import instanced_field

    insts = instanced_field(n_tris=300, n_inst=4)
    cfg = _field_cfg(spp_per_step=1)
    a = AdaptiveRenderer(cfg, insts, tile=8, warmup=1)
    a.step(1)
    b = AdaptiveRenderer(cfg, flatten_instances(insts), tile=8, warmup=1)
    b.step(1)
    np.testing.assert_array_equal(a.image(), b.image())
