"""Benchmark harness: renders the contest-class scene on a GPU.

Prints ONE JSON line: {"metric", "value", "unit", ..., "device"}, where
"device" names the platform, device kind and count JAX reports and the
card's name and power limit from nvidia-smi.  Without a GPU it fails
(``--cpu``, the native C++ baseline, excepted).

Workload: a procedural contest-class scene (the reference's Round1 scene is
out-of-repo) at the reference's defaults — grid 128³, 3 spp, 4 bounces
(config.json:1-6) — at 1080p-class resolution, mirroring the contest render
configuration ("--height 1080", BASELINE.md).  Metric: Mrays/s = traced path
segments / render wall-clock.  The first wave's jit compile is excluded via
a warmup render at the same shapes.  ``--large``: the ~100k-triangle
terrain.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path


def build_bench_scene(path: Path, num_objects: int = 200, seed: int = 42):
    """Contest-class content: a box room + a field of textured boxes/quads
    (~few thousand triangles), one emissive panel, mixed materials."""
    import numpy as np

    from zig_raytracing_contest_tpu.scene.procedural import SceneBuilder, quad

    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    # checker texture (repeat), a clamp texture, an alpha-cutout texture
    checker = np.zeros((8, 8, 4), np.uint8)
    checker[::2, ::2] = checker[1::2, 1::2] = [230, 230, 230, 255]
    checker[::2, 1::2] = checker[1::2, ::2] = [40, 40, 40, 255]
    img_checker = b.add_image_png(checker)
    tex_checker = b.add_texture(img_checker, b.add_sampler(10497, 10497))

    grad = np.linspace(30, 220, 16).astype(np.uint8)
    grad_img = np.stack([grad, 255 - grad, np.full(16, 128, np.uint8)], -1)[None]
    tex_grad = b.add_texture(
        b.add_image_png(np.ascontiguousarray(grad_img)), b.add_sampler(33071, 33071)
    )

    holes = np.full((8, 8, 4), 255, np.uint8)
    holes[2:6, 2:6, 3] = 0
    tex_holes = b.add_texture(b.add_image_png(holes))

    floor_mat = b.add_material(base_color_texture=tex_checker)
    grad_mat = b.add_material(base_color_texture=tex_grad)
    cut_mat = b.add_material(
        base_color_texture=tex_holes, alpha_mode="MASK", alpha_cutoff=0.5
    )
    light = b.add_material(base_color_factor=(0, 0, 0, 1), emissive_factor=(6, 6, 6))
    plain = [
        b.add_material(base_color_factor=(rng.uniform(0.2, 0.9, 3).tolist() + [1.0]))
        for _ in range(8)
    ]

    S = 12.0
    p, i, n, t = quad((0, -2, 0), (S, 0, 0), (0, 0, -S))
    b.add_mesh_node(p, i, floor_mat, normals=n, texcoords=t * 6)
    p, i, n, t = quad((0, 8, 0), (4, 0, 0), (0, 0, 4))
    b.add_mesh_node(p, i, light, normals=n, texcoords=t)

    for k in range(num_objects):
        c = rng.uniform([-8, -1.5, -8], [8, 3, 8])
        size = rng.uniform(0.2, 0.7)
        mat = [grad_mat, cut_mat, *plain][k % (len(plain) + 2)]
        # random oriented quad pair (two-sided via two quads back to back)
        u = rng.standard_normal(3)
        u /= np.linalg.norm(u)
        v = rng.standard_normal(3)
        v -= u * (v @ u)
        v /= np.linalg.norm(v)
        for flip in (1, -1):
            p, i, n, t = quad(c, u * size, v * size * flip)
            b.add_mesh_node(p, i, mat, normals=n, texcoords=t)

    b.add_camera_node((0, 2.5, 14), (0, 0.5, 0), yfov=0.8, name="Camera 1")
    return b.write_gltf(path)


def build_large_scene(path: Path, side: int = 224, seed: int = 7):
    """~100k-triangle enclosed scene: a finely tessellated terrain inside a
    lit room — Sponza-class triangle count with realistic occupancy (most
    rays hit geometry; bounce rays are incoherent)."""
    import numpy as np

    from zig_raytracing_contest_tpu.scene.procedural import SceneBuilder, quad

    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    checker = np.zeros((8, 8, 4), np.uint8)
    checker[::2, ::2] = checker[1::2, 1::2] = [210, 210, 210, 255]
    checker[::2, 1::2] = checker[1::2, ::2] = [60, 60, 90, 255]
    terrain_mat = b.add_material(
        base_color_texture=b.add_texture(b.add_image_png(checker))
    )
    wall = b.add_material(base_color_factor=(0.6, 0.6, 0.65, 1.0))
    light = b.add_material(base_color_factor=(0, 0, 0, 1), emissive_factor=(8, 8, 8))

    # Terrain: (side)x(side) quads -> 2*side^2 triangles (224 -> 100,352).
    n = side + 1
    xs = np.linspace(-10, 10, n, dtype=np.float32)
    zs = np.linspace(-10, 10, n, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs)
    y = (
        1.2 * np.sin(xg * 0.9) * np.cos(zg * 0.7)
        + 0.35 * np.sin(xg * 3.1 + 1.0) * np.sin(zg * 2.7)
        + rng.normal(0, 0.02, xg.shape)
    ).astype(np.float32)
    pos = np.stack([xg, y, zg], axis=-1).reshape(-1, 3)
    idx = []
    for j in range(side):
        for i in range(side):
            a = j * n + i
            idx += [a, a + n, a + 1, a + 1, a + n, a + n + 1]
    idx = np.asarray(idx, np.uint32)
    tri = idx.reshape(-1, 3)
    fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]], pos[tri[:, 2]] - pos[tri[:, 0]])
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, tri[:, k], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    uv = np.stack(
        [(xg + 10) / 20 * 16, (zg + 10) / 20 * 16], axis=-1
    ).reshape(-1, 2).astype(np.float32)
    b.add_mesh_node(
        pos, idx, terrain_mat, normals=nrm, texcoords=uv, index_dtype=np.uint32
    )

    S = 11.0
    for center, uax, vax, mat in [
        ((0, 7, 0), (S, 0, 0), (0, 0, S), light),      # ceiling light
        ((0, 0, -S), (S, 0, 0), (0, 7, 0), wall),      # walls
        ((0, 0, S), (-S, 0, 0), (0, 7, 0), wall),
        ((-S, 0, 0), (0, 0, S), (0, 7, 0), wall),
        ((S, 0, 0), (0, 0, -S), (0, 7, 0), wall),
    ]:
        p, i2, n2, t2 = quad(center, uax, vax)
        b.add_mesh_node(p, i2, mat, normals=n2, texcoords=t2)

    b.add_camera_node((0, 4.5, 9.5), (0, 0.5, 0), yfov=0.9, name="Camera 1")
    return b.write_gltf(path)


REPS = 5  # in-process repetitions; the headline is their median


def _stats(rates):
    """(median, best, spread%) of a rate list."""
    s = sorted(rates)
    med = s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])
    best = s[-1]
    spread = 100.0 * (s[-1] - s[0]) / med if med else 0.0
    return round(med, 3), round(best, 3), round(spread, 1)


def _device() -> dict:
    """The device JAX renders on, plus the card's name and power limit;
    raises without a GPU."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX's first device is {devs[0].platform!r}"
        )
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card}


def run_large() -> int:
    """--large: 100k-triangle throughput."""
    from zig_raytracing_contest_tpu.config import Config
    from zig_raytracing_contest_tpu.render.pipeline import prepare_scene, render_scene

    device = _device()
    width, height = 1280, 720
    config = Config(
        grid_resolution=(128, 128, 128), num_samples=2, max_bounce=3,
        wave_size=1 << 21,
    )
    with tempfile.TemporaryDirectory() as d:
        scene_path = build_large_scene(Path(d) / "large.gltf")
        scene, camera, _ = prepare_scene(
            str(scene_path), config, camera_name="Camera 1",
            width=width, height=height,
        )
    render_scene(scene, camera, config)  # warmup/compile
    rates, segments = [], 0
    for _ in range(REPS):
        t0 = time.perf_counter()
        _, stats = render_scene(scene, camera, config)
        wall = time.perf_counter() - t0
        rates.append(stats.segments / wall / 1e6)
        segments = stats.segments
        print(f"large rep: {rates[-1]:.3f} Mrays/s", file=sys.stderr)
    med, best, spread = _stats(rates)
    print(
        json.dumps(
            {
                "metric": "large_Mrays/s",
                "value": med,  # median-of-N: the honest headline
                "unit": "Mrays/s",
                "best": best,
                "spread_pct": spread,
                "triangles": 2 * 224 * 224 + 10,
                "segments": segments,
                "device": device,
            }
        )
    )
    return 0


def main() -> int:
    import jax

    from zig_raytracing_contest_tpu.config import Config
    from zig_raytracing_contest_tpu.render.pipeline import prepare_scene, render_scene

    if "--large" in sys.argv:
        return run_large()

    device = None if "--cpu" in sys.argv else _device()
    width, height = 1920, 1080
    config = Config(
        grid_resolution=(128, 128, 128), num_samples=3, max_bounce=4,
        wave_size=1 << 19,
    )

    with tempfile.TemporaryDirectory() as d:
        scene_path = build_bench_scene(Path(d) / "bench.gltf")
        scene, camera, _ = prepare_scene(
            str(scene_path), config, camera_name="Camera 1",
            width=width, height=height,
        )

    if "--cpu" in sys.argv:
        # Reference-equivalent CPU baseline (native/cpu_tracer.cpp): the
        # denominator for the "≥10× the CPU build" target (BASELINE.md).
        # Same scene, same workload, all host cores.
        import os

        from zig_raytracing_contest_tpu.render.native_cpu import render_cpu

        render_cpu(scene, camera, spp=1, max_bounce=1)  # warm build/pages
        _, segments, seconds = render_cpu(
            scene, camera, spp=config.num_samples, max_bounce=config.max_bounce
        )
        print(
            json.dumps(
                {
                    "metric": "cpu_Mrays/s",
                    "value": round(segments / seconds / 1e6, 3),
                    "unit": "Mrays/s",
                    "threads": os.cpu_count(),
                    "segments": segments,
                    "seconds": round(seconds, 3),
                }
            )
        )
        return 0

    # Warmup at identical shapes: excludes XLA compile from the timing.
    warm_cfg = Config(
        grid_resolution=config.grid_resolution, num_samples=config.num_samples,
        max_bounce=config.max_bounce, wave_size=config.wave_size,
    )
    render_scene(scene, camera, warm_cfg)
    jax.block_until_ready(jax.device_put(0))

    rates = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        img, stats = render_scene(scene, camera, config)
        wall = time.perf_counter() - t0
        rates.append(stats.segments / wall / 1e6)
        print(f"official rep: {rates[-1]:.3f} Mrays/s", file=sys.stderr)
    med, best, spread = _stats(rates)

    print(
        json.dumps(
            {
                "metric": "Mrays/s",
                "value": med,  # median-of-N: the honest headline
                "unit": "Mrays/s",
                "best": best,
                "spread_pct": spread,
                "device": device,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
