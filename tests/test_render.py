"""End-to-end render tests: trace vs oracle, deterministic + statistical."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from zig_raytracing_contest_tpu.config import Config
from zig_raytracing_contest_tpu.grid.builder import build_grid
from zig_raytracing_contest_tpu.render.oracle import Oracle
from zig_raytracing_contest_tpu.render.pipeline import prepare_scene, render_scene
from zig_raytracing_contest_tpu.render.wavefront import trace_wave
from zig_raytracing_contest_tpu.scene import procedural
from zig_raytracing_contest_tpu.scene.camera import load_camera
from zig_raytracing_contest_tpu.scene.geometry import load_geometry
from zig_raytracing_contest_tpu.scene.gltf import load_gltf
from zig_raytracing_contest_tpu.scene.materials import load_materials
from zig_raytracing_contest_tpu.scene.types import build_device_scene

W = H = 24


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    path = procedural.cornell_like_box(d / "box.gltf")
    gltf = load_gltf(path)
    cam = load_camera(gltf, width=W, height=H)
    geo = load_geometry(gltf)
    mats = load_materials(gltf)
    grid = build_grid(geo.positions, (8, 8, 8))
    scene = build_device_scene(geo, grid, mats, backend="grid")
    return path, gltf, cam, geo, mats, scene


@pytest.fixture(scope="module")
def box_mxu(box):
    _, _, cam, geo, mats, _ = box
    grid = build_grid(geo.positions, (8, 8, 8))
    return cam, build_device_scene(geo, grid, mats, backend="mxu")


def primary_rays(cam, w, h):
    # Irrational in-pixel offsets: centered offsets on a symmetric scene put
    # many rays exactly on quad seams, where hit/miss is ULP-dependent.
    xs, ys = np.meshgrid(np.arange(w) + 0.3183, np.arange(h) + 0.618)
    dirs = (
        cam.lower_left_corner
        + cam.right * xs.reshape(-1, 1).astype(np.float32)
        + cam.up * ys.reshape(-1, 1).astype(np.float32)
    )
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    orig = np.tile(cam.origin, (w * h, 1)).astype(np.float32)
    return orig, dirs


def test_grid_trace_matches_brute_force(box):
    """The grid may never change visibility vs. brute-force over all tris.

    Rare ULP-level mismatches on silhouette-grazing rays are tolerated
    (< 1%), same as any float-order difference would produce.
    """
    _, _, cam, geo, mats, scene = box
    orig, dirs = primary_rays(cam, W, H)
    res = trace_wave(scene, jnp.asarray(orig), jnp.asarray(dirs), jnp.ones(W * H, bool))
    t_dev = np.asarray(res.t)
    tri_dev = np.asarray(scene.dup_to_tri)[np.asarray(res.dup_idx)]
    oracle = Oracle(geo, mats)

    mismatches = 0
    for i in range(W * H):
        t, u, v, idx = oracle.trace(orig[i], dirs[i])
        if np.isinf(t) != np.isinf(t_dev[i]):
            mismatches += 1
        elif np.isfinite(t) and (idx != tri_dev[i] or abs(t - t_dev[i]) > 1e-3):
            mismatches += 1
    assert mismatches <= max(2, W * H // 100), f"{mismatches} trace mismatches"


def test_mxu_backend_matches_grid_trace(box, box_mxu):
    """The MXU brute-force intersector implements the identical hit rule:
    same nearest hit, same back-face cull, same barycentrics (float tol)."""
    from zig_raytracing_contest_tpu.render.wavefront import trace_any

    _, _, cam, _, _, scene_grid = box
    _, scene_mxu = box_mxu
    orig, dirs = primary_rays(cam, W, H)
    o, d, act = jnp.asarray(orig), jnp.asarray(dirs), jnp.ones(W * H, bool)
    tg, ug, vg, ig = (np.asarray(x) for x in trace_any(scene_grid, o, d, act))
    tm, um, vm, im = (np.asarray(x) for x in trace_any(scene_mxu, o, d, act))
    both_hit = np.isfinite(tg) & np.isfinite(tm)
    # visibility agreement (ULP-edge cases excepted)
    assert (np.isfinite(tg) != np.isfinite(tm)).sum() <= max(2, W * H // 100)
    np.testing.assert_array_equal(ig[both_hit], im[both_hit])
    np.testing.assert_allclose(tg[both_hit], tm[both_hit], atol=1e-3)
    np.testing.assert_allclose(ug[both_hit], um[both_hit], atol=1e-3)
    np.testing.assert_allclose(vg[both_hit], vm[both_hit], atol=1e-3)


def test_previous_hit_exclusion(box, box_mxu):
    """Continuation rays can never phantom-re-hit their own triangle.

    The reference's ``t + floatEps`` nudge (src/stage3.zig:209,216) is a
    rounding no-op at t >= 2, so without exclusion a re-trace from the hit
    point re-hits the SAME triangle at t ~ 0 purely by backend rounding
    (EXCLUDE_PREV_HIT comment, ops/mxu_intersect.py).  Both backends:
    re-trace with exclude=<hit tri> must (a) never return the same
    triangle, (b) never return a t ~ 0 phantom."""
    from zig_raytracing_contest_tpu.render.wavefront import (
        FLT_EPSILON, trace_any,
    )

    _, _, cam, _, _, scene_grid = box
    _, scene_mxu = box_mxu
    orig, dirs = primary_rays(cam, W, H)
    o, d, act = jnp.asarray(orig), jnp.asarray(dirs), jnp.ones(W * H, bool)
    for scene in (scene_grid, scene_mxu):
        t, u, v, tri = (np.asarray(x) for x in trace_any(scene, o, d, act))
        hit = np.isfinite(t)
        assert hit.any()
        new_o = orig + dirs * (t + FLT_EPSILON).reshape(-1, 1)
        t2, _, _, tri2 = (
            np.asarray(x)
            for x in trace_any(
                scene, jnp.asarray(new_o), d, jnp.asarray(hit),
                exclude=jnp.asarray(tri),
            )
        )
        hit2 = np.isfinite(t2) & hit
        assert not (tri2[hit2] == tri[hit2]).any(), "re-hit own triangle"
        # In the closed box every continuation hit is a real far wall, not
        # a t~0 phantom of the origin surface.
        assert (t2[hit2] > 1e-3).all()


@pytest.mark.slow
def test_mxu_render_close_to_grid_render(box, box_mxu):
    _, _, cam, _, _, scene_grid = box
    _, scene_mxu = box_mxu
    cfg = Config(num_samples=2, max_bounce=3, seed=3)
    img_g, _ = render_scene(scene_grid, cam, cfg)
    img_m, _ = render_scene(scene_mxu, cam, cfg)
    # Same RNG streams, same hit rule → images agree except float-edge pixels.
    diff = np.abs(img_g.astype(int) - img_m.astype(int))
    assert (diff > 2).mean() < 0.02, f"backends diverge: {(diff > 2).mean()}"


def test_inactive_rays_report_miss(box, box_mxu):
    """Both backends honor the miss-on-inactive contract."""
    from zig_raytracing_contest_tpu.ops.mxu_intersect import nearest_hit_mxu

    *_, scene = box
    _, scene_mxu = box_mxu
    orig = jnp.zeros((8, 3), jnp.float32)
    dirs = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (8, 1))
    res = trace_wave(scene, orig, dirs, jnp.zeros(8, bool))
    assert bool(jnp.all(jnp.isinf(res.t)))
    t, _, _, _ = nearest_hit_mxu(scene_mxu.mxu, orig, dirs, jnp.zeros(8, bool))
    assert bool(jnp.all(jnp.isinf(t)))


def test_render_deterministic_and_wave_size_invariant(box):
    _, _, cam, _, _, scene = box
    cfg_a = Config(num_samples=2, max_bounce=2, wave_size=W * H * 2, seed=7)
    cfg_b = Config(num_samples=2, max_bounce=2, wave_size=W * H // 2, seed=7)
    img_a, _ = render_scene(scene, cam, cfg_a)
    img_b, _ = render_scene(scene, cam, cfg_b)
    # Per-ray counter RNG: identical output regardless of wave partitioning.
    np.testing.assert_array_equal(img_a, img_b)
    img_c, _ = render_scene(scene, cam, Config(num_samples=2, max_bounce=2, seed=8))
    assert np.any(img_c != img_a)


def test_multibounce_gi_statistics(box):
    """Cornell-style sanity: left wall bleeds red, right bleeds green, and
    overall brightness matches the brute-force oracle within noise."""
    _, _, cam, geo, mats, scene = box
    cfg = Config(num_samples=48, max_bounce=4, seed=1)
    img, stats = render_scene(scene, cam, cfg)
    assert stats.segments > W * H * cfg.num_samples  # multi-bounce happened

    f = img.astype(np.float32) / 255.0
    left = f[H // 3 : 2 * H // 3, : W // 4]
    right = f[H // 3 : 2 * H // 3, -W // 4 :]
    assert left[..., 0].mean() > left[..., 1].mean() + 0.05, "left wall not red"
    assert right[..., 1].mean() > right[..., 0].mean() + 0.05, "right wall not green"

    oracle = Oracle(geo, mats)
    rng = np.random.default_rng(0)
    # Sparse oracle sampling: 16 random pixels, high spp, compare means.
    px = rng.integers(0, W, 16)
    py = rng.integers(0, H, 16)
    got = f[py, px].mean()
    want = np.mean(
        [
            oracle.render_pixel(cam, x, y, 48, 4, rng) ** (1 / 2.2)
            for x, y in zip(px, py)
        ]
    )
    assert abs(got - want) < 0.08, f"render mean {got} vs oracle {want}"


def test_emissive_only_exact(tmp_path):
    """max_bounce=1: pixel is exactly emissive (hit) or sky (miss) — no RNG
    beyond jitter, so interior pixels are bit-exact predictable."""
    b = procedural.SceneBuilder()
    mat = b.add_material(base_color_factor=(0, 0, 0, 1), emissive_factor=(0.3, 0.5, 0.9))
    p, i, n, t = procedural.quad((0, 0, 0), (4, 0, 0), (0, 4, 0))
    b.add_mesh_node(p, i, mat, normals=n, texcoords=t)
    b.add_camera_node((0, 0, 2), (0, 0, 0), yfov=0.9, name="c")
    gltf = load_gltf(b.write_gltf(tmp_path / "e.gltf"))
    cam = load_camera(gltf, width=16, height=16)
    geo = load_geometry(gltf)
    mats = load_materials(gltf)
    scene = build_device_scene(geo, build_grid(geo.positions, (4, 4, 4)), mats)
    img, _ = render_scene(scene, cam, Config(num_samples=1, max_bounce=1))
    expected = np.trunc(
        np.minimum(np.asarray([0.3, 0.5, 0.9]) ** (1 / 2.2), 0.999999) * 256
    ).astype(np.uint8)
    center = img[6:10, 6:10]
    assert np.all(center == expected), f"{center[0, 0]} != {expected}"


def test_stochastic_alpha_pass_through(tmp_path):
    """A fully transparent quad in front of an emissive quad: rays must pass
    straight through (same direction) and still find the emitter with one
    bounce consumed."""
    b = procedural.SceneBuilder()
    # transparent quad: BLEND mode + alpha=0 texture
    img_t = b.add_image_png(np.asarray([[[255, 255, 255, 0]]], np.uint8))
    tex = b.add_texture(img_t)
    glass = b.add_material(base_color_texture=tex, alpha_mode="BLEND")
    emit = b.add_material(base_color_factor=(0, 0, 0, 1), emissive_factor=(1, 0, 0))
    p, i, n, t = procedural.quad((0, 0, 1), (3, 0, 0), (0, 3, 0))
    b.add_mesh_node(p, i, glass, normals=n, texcoords=t)
    p, i, n, t = procedural.quad((0, 0, 0), (3, 0, 0), (0, 3, 0))
    b.add_mesh_node(p, i, emit, normals=n, texcoords=t)
    b.add_camera_node((0, 0, 2.5), (0, 0, 0), yfov=0.9, name="c")
    gltf = load_gltf(b.write_gltf(tmp_path / "g.gltf"))
    cam = load_camera(gltf, width=8, height=8)
    geo = load_geometry(gltf)
    mats = load_materials(gltf)
    scene = build_device_scene(geo, build_grid(geo.positions, (4, 4, 4)), mats)
    # 2 bounces: one consumed by the pass-through, one to shade the emitter.
    img2, _ = render_scene(scene, cam, Config(num_samples=1, max_bounce=2))
    expected_r = int(np.trunc(min(1.0 ** (1 / 2.2), 0.999999) * 256))
    assert np.all(img2[3:5, 3:5, 0] == expected_r)
    assert np.all(img2[3:5, 3:5, 1:] == 0)
    # 1 bounce: the pass-through eats the budget → black behind the glass.
    img1, _ = render_scene(scene, cam, Config(num_samples=1, max_bounce=1))
    assert np.all(img1[3:5, 3:5] == 0)


def test_cli_end_to_end(tmp_path, monkeypatch):
    from zig_raytracing_contest_tpu.cli import main

    scene_path = procedural.cornell_like_box(tmp_path / "s.glb", glb=True)
    cfg = {
        "grid_resolution": [8, 8, 8],
        "num_threads": None,
        "num_samples": 2,
        "max_bounce": 2,
    }
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "out.png"
    rc = main(
        [
            "--in", str(scene_path),
            "--out", str(out),
            "--camera", "Camera 1",
            "--width", "16",
            "--height", "16",
            "--config", str(cfg_path),
        ]
    )
    assert rc == 0
    from PIL import Image

    assert Image.open(out).size == (16, 16)


def test_progressive_dump(tmp_path, box):
    """progressive_every writes intermediate PNGs during the render
    (the reference has no progressive mode; an extension here)."""
    _, gltf, _, _, _, scene = box
    # Need several waves: wave quantum is spp*1024, so use a larger camera.
    cam = load_camera(gltf, width=48, height=48)
    out = tmp_path / "prog.png"
    cfg = Config(num_samples=2, max_bounce=2, wave_size=2048, progressive_every=1)
    from zig_raytracing_contest_tpu.render.pipeline import render_scene as rs

    img, _ = rs(scene, cam, cfg, progressive_path=str(out))
    assert out.exists()  # at least one intermediate dump happened
    from PIL import Image

    assert Image.open(out).size == (48, 48)


def test_odd_spp_small_image_waves(box):
    """Wave quantization must satisfy the trace kernel's block constraint
    even for odd spp × small images."""
    _, _, cam, _, _, scene = box
    img, stats = render_scene(scene, cam, Config(num_samples=3, max_bounce=2))
    assert img.shape == (H, W, 3)
    assert stats.segments > 0


def test_pipeline_prepare_scene(tmp_path):
    path = procedural.cornell_like_box(tmp_path / "p.gltf")
    cfg = Config(grid_resolution=(8, 8, 8))
    scene, cam, timers = prepare_scene(str(path), cfg, width=8, height=8)
    assert cam.width == 8
    assert scene.tri_v0.shape[0] == scene.dup_to_tri.shape[0]
    assert "load" in timers.phases and "compile" in timers.phases


def test_huge_ray_count_rejected(box):
    """Ray ids are int32; ray counts at/above 2^31 get a clear error
    instead of silent wraparound (4096×4096×128 spp = exactly 2^31)."""
    _, gltf, _, _, _, scene = box
    cam = load_camera(gltf, width=4096, height=4096)
    with pytest.raises(ValueError, match="rays"):
        render_scene(scene, cam, Config(num_samples=128, max_bounce=1))


def test_wave_pixel_coords_exact_at_8k_bases():
    """pixel/x/y must be exact for pixel bases past f32's 2^24 integer
    range — 8K images and far device tiles (deriving the base from g_start
    via f32 divmod rounded it)."""
    from zig_raytracing_contest_tpu.render.wavefront import wave_pixel_coords

    width, spp = 7680, 3
    local = np.arange(spp * 4096, dtype=np.int32)
    # Bases: 0; odd just past 2^24 (f32-inexact); last wave of 8K×4320.
    for base in [0, (1 << 24) + 1, 7680 * 4320 - 4096, 23_456_789]:
        pixel, x, y = wave_pixel_coords(
            jnp.asarray(local), spp, width, jnp.int32(base)
        )
        expect_pixel = base + local // spp
        np.testing.assert_array_equal(np.asarray(pixel), expect_pixel)
        np.testing.assert_array_equal(
            np.asarray(x).astype(np.int64), expect_pixel % width
        )
        np.testing.assert_array_equal(
            np.asarray(y).astype(np.int64), expect_pixel // width
        )


@pytest.mark.slow
def test_above_2p23_pixel_render_smoke(box, box_mxu):
    """Images above 2^23 pixels render (the r1 build hard-errored here).
    4097×2048 = 8,390,656 pixels > 2^23; 1 spp, 1 bounce keeps it cheap."""
    _, gltf, _, _, _, _ = box
    _, scene = box_mxu
    w, h = 4097, 2048
    cam = load_camera(gltf, width=w, height=h)
    img, stats = render_scene(scene, cam, Config(num_samples=1, max_bounce=1))
    assert img.shape == (h, w, 3)
    assert stats.segments == w * h  # every primary ray traced once
    # Content sanity: the image is not a constant field.
    assert img.std() > 0
