"""Opt-in extensions (NEE, Russian roulette, pbr) — render/extensions.py.

The reference has none of these (SURVEY.md §7.7 stretch goals); they must
be OFF by default, and when enabled: NEE and RR estimate the SAME image as
the plain path tracer (statistical agreement), NEE reduces variance, RR
reduces traced segments, and pbr changes materials in the physically
expected direction.
"""

import numpy as np
import pytest

from zig_raytracing_contest_tpu.config import Config
from zig_raytracing_contest_tpu.grid.builder import build_grid
from zig_raytracing_contest_tpu.render.pipeline import render_scene
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
    scene = build_device_scene(geo, build_grid(geo.positions, (8, 8, 8)), mats)
    return cam, scene


def _mean_img(scene, cam, cfg):
    img, stats = render_scene(scene, cam, cfg)
    return img.astype(np.float64), stats


def test_flags_off_by_default():
    cfg = Config()
    assert not (cfg.nee or cfg.russian_roulette or cfg.pbr)
    assert not cfg.ext_flags.any


def test_light_set_built(box):
    _, scene = box
    assert scene.lights is not None
    assert float(scene.lights.total_area[0]) > 0
    assert np.allclose(float(scene.lights.cdf[-1]), 1.0)


def test_nee_matches_plain_estimator(box):
    """Same integral, different estimator: images agree in the mean and NEE
    has LOWER noise at equal spp (the whole point of the extension)."""
    cam, scene = box
    plain, _ = _mean_img(scene, cam, Config(num_samples=48, max_bounce=4, seed=3))
    nee, _ = _mean_img(
        scene, cam, Config(num_samples=48, max_bounce=4, seed=3, nee=True)
    )
    # Mean brightness agreement (diffuse GI, emissive light sampled two ways)
    assert abs(plain.mean() - nee.mean()) / max(plain.mean(), 1) < 0.06
    # Per-pixel agreement within Monte-Carlo noise (the plain estimator at
    # 48 spp is itself noisy; the strict check is the variance one below)
    assert np.abs(plain - nee).mean() < 25.0

    # Variance reduction: render both at low spp with two seeds; NEE's
    # seed-to-seed per-pixel variation must be smaller.
    def noise(**kw):
        a, _ = _mean_img(scene, cam, Config(num_samples=2, max_bounce=4, seed=1, **kw))
        b, _ = _mean_img(scene, cam, Config(num_samples=2, max_bounce=4, seed=2, **kw))
        return np.abs(a - b).mean()

    assert noise(nee=True) < noise() * 0.8


def test_russian_roulette_unbiased_and_cheaper(box):
    cam, scene = box
    plain, stats_p = _mean_img(scene, cam, Config(num_samples=32, max_bounce=6, seed=5))
    rr, stats_r = _mean_img(
        scene, cam,
        Config(num_samples=32, max_bounce=6, seed=5, russian_roulette=True),
    )
    assert stats_r.segments < stats_p.segments  # killed paths = fewer segments
    assert abs(plain.mean() - rr.mean()) / max(plain.mean(), 1) < 0.06


def test_pbr_metallic_mirror(tmp_path):
    """roughness=0, metallic=1 ⇒ the specular path is DETERMINISTIC:
    a floor pixel must equal albedo × sky(reflect(dir)) analytically —
    something the Lambertian estimator (hemisphere integral) cannot match."""
    b = procedural.SceneBuilder()
    metal = b.add_material(
        base_color_factor=(0.9, 0.9, 0.9, 1.0), metallic=1.0, roughness=0.0
    )
    p, i, n, t = procedural.quad((0, -1, 0), (8, 0, 0), (0, 0, -8))
    b.add_mesh_node(p, i, metal, normals=n, texcoords=t)
    b.add_camera_node((0, 1.5, 5), (0, -0.5, 0), yfov=0.8, name="c")
    gltf = load_gltf(b.write_gltf(tmp_path / "m.gltf"))
    cam = load_camera(gltf, width=32, height=32)
    geo = load_geometry(gltf)
    mats = load_materials(gltf)
    assert float(mats.mat_metallic[metal]) == 1.0
    scene = build_device_scene(geo, build_grid(geo.positions, (4, 4, 4)), mats)

    pbr, _ = _mean_img(
        scene, cam, Config(num_samples=4, max_bounce=3, seed=1, pbr=True)
    )
    plain, _ = _mean_img(scene, cam, Config(num_samples=4, max_bounce=3, seed=1))

    # Analytic prediction for pixel-center rays of the bottom rows.
    xs, ys = np.meshgrid(np.arange(32) + 0.5, np.arange(32) + 0.5)
    dirs = (
        cam.lower_left_corner
        + cam.right * xs[..., None].astype(np.float32)
        + cam.up * ys[..., None].astype(np.float32)
    )
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    hits_floor = dirs[..., 1] < -0.05  # clear of the horizon band
    refl_y = -dirs[..., 1]  # mirror on y = -1 flips dy
    t_sky = 0.5 * (refl_y + 1.0)
    sky = np.stack([1 - 0.5 * t_sky, 1 - 0.3 * t_sky, np.ones_like(t_sky)], -1)
    expect = np.clip((0.9 * sky) ** (1 / 2.2), 0, 0.999999) * 256.0
    sel = hits_floor & (ys > 24)  # well inside the floor region
    err_pbr = np.abs(pbr[sel] - expect[sel]).mean()
    err_plain = np.abs(plain[sel] - expect[sel]).mean()
    assert err_pbr < 1.0, f"mirror prediction off by {err_pbr}"
    # The diffuse floor under this near-white sky is similar but measurably
    # NOT the mirror image (≈0.35 vs ≈2.2 mean u8 error).
    assert err_plain > err_pbr * 3


def test_config_parses_extension_keys(tmp_path):
    import json

    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(
        json.dumps(
            {
                "grid_resolution": [8, 8, 8],
                "num_threads": None,
                "num_samples": 1,
                "max_bounce": 2,
                "nee": True,
                "russian_roulette": True,
                "pbr": False,
            }
        )
    )
    cfg = Config.load(str(cfg_path))
    assert cfg.nee and cfg.russian_roulette and not cfg.pbr
    assert cfg.ext_flags.any


def test_nee_two_sided_geometry_no_self_shadow(tmp_path):
    """Shadow rays must lift off along the shading normal: geometry authored
    two-sided (back-to-back quads, as the reference's single-sided triangles
    require) would otherwise self-occlude every NEE sample and the floor
    would lose all direct light."""
    b = procedural.SceneBuilder()
    # Dim materials: a saturating scene would clip the noisier plain
    # estimator's bright samples and bias the mean comparison.
    white = b.add_material(base_color_factor=(0.35, 0.35, 0.35, 1))
    light = b.add_material(base_color_factor=(0, 0, 0, 1), emissive_factor=(3, 3, 3))
    for flip in (1, -1):  # two-sided floor
        p, i, n, t = procedural.quad((0, -1, 0), (2, 0, 0), (0, 0, -2 * flip))
        b.add_mesh_node(p, i, white, normals=n, texcoords=t)
    p, i, n, t = procedural.quad((0, 1.5, 0), (1, 0, 0), (0, 0, 1))
    b.add_mesh_node(p, i, light, normals=n, texcoords=t)
    b.add_camera_node((0, 0.5, 3), (0, -0.5, 0), yfov=0.8, name="c")
    gltf = load_gltf(b.write_gltf(tmp_path / "ts.gltf"))
    cam = load_camera(gltf, width=24, height=24)
    geo = load_geometry(gltf)
    scene = build_device_scene(
        geo, build_grid(geo.positions, (4, 4, 4)), load_materials(gltf)
    )
    plain, _ = _mean_img(scene, cam, Config(num_samples=48, max_bounce=3, seed=4))
    nee, _ = _mean_img(
        scene, cam, Config(num_samples=48, max_bounce=3, seed=4, nee=True)
    )
    # Self-shadowing would kill the direct term: NEE floor must be at least
    # comparably bright to the plain estimator's.
    assert nee.mean() > plain.mean() * 0.85
    assert abs(nee.mean() - plain.mean()) / max(plain.mean(), 1) < 0.1
