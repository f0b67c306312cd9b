"""Multi-device pixel-tile sharding on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from zig_raytracing_contest_tpu.config import Config
from zig_raytracing_contest_tpu.grid.builder import build_grid
from zig_raytracing_contest_tpu.parallel.sharding import make_mesh, render_scene_sharded
from zig_raytracing_contest_tpu.render.pipeline import render_scene
from zig_raytracing_contest_tpu.scene import procedural
from zig_raytracing_contest_tpu.scene.camera import load_camera
from zig_raytracing_contest_tpu.scene.geometry import load_geometry
from zig_raytracing_contest_tpu.scene.gltf import load_gltf
from zig_raytracing_contest_tpu.scene.materials import load_materials
from zig_raytracing_contest_tpu.scene.types import build_device_scene


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    path = procedural.cornell_like_box(d / "box.gltf")
    gltf = load_gltf(path)
    cam = load_camera(gltf, width=16, height=16)
    geo = load_geometry(gltf)
    scene = build_device_scene(
        geo, build_grid(geo.positions, (8, 8, 8)), load_materials(gltf)
    )
    return cam, scene


def test_eight_virtual_devices_available():
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_matches_single_device(box, n):
    cam, scene = box
    cfg = Config(num_samples=2, max_bounce=3, seed=5, wave_size=2048)
    single, stats_s = render_scene(scene, cam, cfg)
    sharded, stats_m = render_scene_sharded(scene, cam, cfg, make_mesh(n))
    # Per-ray counter RNG + per-device pixel tiles ⇒ bit-identical output.
    np.testing.assert_array_equal(single, sharded)
    assert stats_s.segments == stats_m.segments


def test_cli_devices_flag(box, tmp_path):
    """--devices N routes through the sharded renderer end-to-end."""
    import json

    from zig_raytracing_contest_tpu.cli import main
    from zig_raytracing_contest_tpu.scene import procedural

    scene_path = procedural.cornell_like_box(tmp_path / "s.glb", glb=True)
    cfg = tmp_path / "config.json"
    cfg.write_text(
        json.dumps(
            {
                "grid_resolution": [8, 8, 8],
                "num_threads": None,
                "num_samples": 1,
                "max_bounce": 2,
            }
        )
    )
    out = tmp_path / "out.png"
    rc = main(
        [
            "--in", str(scene_path),
            "--out", str(out),
            "--camera", "Camera 1",
            "--width", "16",
            "--height", "16",
            "--config", str(cfg),
            "--devices", "2",
        ]
    )
    assert rc == 0
    from PIL import Image

    assert Image.open(out).size == (16, 16)


@pytest.mark.slow
def test_fused_pipeline_under_shard_map(box, monkeypatch):
    """The GPU combination — the Triton trace kernel inside shard_map —
    runs (interpret mode on the CPU) and is bit-identical to the
    single-device kernel render AND close to the sharded XLA-scan render
    (same RNG streams, same hit rule)."""
    from functools import partial

    from zig_raytracing_contest_tpu.ops.trace_kernel import nearest_hit_triton
    from zig_raytracing_contest_tpu.render import wavefront

    cam, scene = box
    assert scene.mxu is not None  # auto backend bakes the bank here
    cfg = Config(num_samples=2, max_bounce=3, seed=5, wave_size=2048)
    sharded_xla, _ = render_scene_sharded(scene, cam, cfg, make_mesh(8))
    kernel = partial(nearest_hit_triton, interpret=True)
    monkeypatch.setattr(wavefront, "select_trace", lambda platform: kernel)
    jax.clear_caches()  # the jitted renders must re-trace with the kernel
    try:
        single_k, stats_k = render_scene(scene, cam, cfg)
        sharded_k, stats_sk = render_scene_sharded(
            scene, cam, cfg, make_mesh(8)
        )
    finally:
        jax.clear_caches()
    np.testing.assert_array_equal(single_k, sharded_k)
    assert stats_k.segments == stats_sk.segments
    diff = np.abs(single_k.astype(int) - sharded_xla.astype(int))
    assert (diff > 2).mean() < 0.02  # float-reassociation pixels only


def test_uneven_pixel_tiles(box):
    cam, scene = box
    # 16x16=256 pixels over 3 devices: 86/86/84 split exercises masking.
    cfg = Config(num_samples=1, max_bounce=2, seed=2)
    single, _ = render_scene(scene, cam, cfg)
    sharded, _ = render_scene_sharded(scene, cam, cfg, make_mesh(3))
    np.testing.assert_array_equal(single, sharded)


@pytest.mark.slow
def test_extensions_under_shard_map(box):
    """NEE + RR inside shard_map: bit-identical to the single-device
    extension render (per-ray counter RNG, same light table)."""
    from zig_raytracing_contest_tpu.render.pipeline import render_scene as rs

    cam, scene = box
    cfg = Config(
        num_samples=2, max_bounce=3, seed=9, wave_size=2048,
        nee=True, russian_roulette=True,
    )
    single, stats_s = rs(scene, cam, cfg)
    sharded, stats_m = render_scene_sharded(scene, cam, cfg, make_mesh(4))
    np.testing.assert_array_equal(single, sharded)
    assert stats_s.segments == stats_m.segments
