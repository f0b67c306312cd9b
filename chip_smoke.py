#!/usr/bin/env python3
"""On-card smoke test: the renderer's main path on one NVIDIA GPU.

Run from the repository root on a machine with the card:

    python chip_smoke.py          # phases 1-4 on one card
    python chip_smoke.py --four   # only the 4-card sharded 4K phase

Phases (any failure exits non-zero and prints no result line):

1. Device check: JAX's first device must be a GPU (never falls back to
   the CPU); prints the card's name and power limit from ``nvidia-smi``.
2. The Triton trace kernel, compiled, at real widths: one 2^19-ray wave of
   primaries and one of bounce-1 rays on the contest scene and on the
   100k-triangle terrain, against ``nearest_hit_xla`` on the same card and,
   on 4096 rays, on the CPU backend; the kernel test cases of
   ``tests/test_trace_kernel.py``; ``memory_analysis()`` of the render step.
3. The CLI, in-process, on the contest scene at 1920x1080 with the
   reference's config.json defaults (grid 128^3, 3 spp, 4 bounces): the
   PNG decodes at the right size, is not black, and more segments than
   primaries were traced.  Run twice: cold (with compilation) and warm.
4. Goldens: the test assets rendered on the card against the committed
   CPU goldens under ``tests/test_golden.py``'s envelope.

The last line is ``{"ok": true, "device": {...}}`` as JAX reports it.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ASSETS = ROOT / "tests" / "assets"
WAVE = 1 << 19
MAIN_SIZE = (1920, 1080)  # the contest render: --height 1080
FOUR_SIZE = (3840, 2160)

# Golden envelope (tests/test_golden.py) and the region-aware alpha bound.
GOLDEN_FRAC = 0.005
GOLDEN_MEAN = 1.0
NOISE_MULT = 1.5  # alpha region: allowed multiple of the CPU seed floor
EXACT_MEAN_BOUND = 0.05  # outside the stochastic-alpha region
EXACT_MAX_BOUND = 8
# Kernel vs the CPU backend: hits nearer than this are self-intersections
# of a continuation ray with a coplanar face, decided by rounding.
SELF_BAND = 1e-3


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """Name and power limit of every card, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise SmokeFailure("nvidia-smi reported no card")
    return out


def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX's first device is {devs[0].platform!r}"
        )
    say(f"card: {card_line()}")
    say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    return devs


def _scenes(tmp: Path, config):
    """(name, scene, camera) for the contest scene and the 100k terrain at
    1920x1080, "Camera 1"."""
    sys.path.insert(0, str(ROOT))
    import bench
    from zig_raytracing_contest_tpu.render.pipeline import prepare_scene

    out = []
    for name, build in (("official", bench.build_bench_scene),
                        ("terrain100k", bench.build_large_scene)):
        path = build(tmp / f"{name}.gltf")
        scene, camera, _ = prepare_scene(
            str(path), config, camera_name="Camera 1", width=MAIN_SIZE[0],
            height=MAIN_SIZE[1],
        )
        out.append((name, scene, camera))
    return out


def wave_rays(scene, camera, spp: int, size: int | None = None,
              seed: int = 0):
    """Primaries of the wave at the middle of the frame (the first rows are
    often all sky), made as render_wave makes them, and the bounce-1 rays
    one XLA bounce makes from them.  Each is (orig, dir, active, exclude)."""
    import jax
    import jax.numpy as jnp

    from zig_raytracing_contest_tpu.ops import linalg, rng
    from zig_raytracing_contest_tpu.ops.mxu_intersect import nearest_hit_mxu
    from zig_raytracing_contest_tpu.render.wavefront import (
        shade_and_scatter,
        wave_pixel_coords,
    )

    size = size or WAVE
    width = camera.width
    pix_base = max(0, (camera.width * camera.height - size // spp) // 2)

    @jax.jit
    def make(scene, origin, llc, right, up):
        local = jnp.arange(size, dtype=jnp.int32)
        streams = rng.ray_streams(jnp.uint32(seed), pix_base * spp + local)
        _, x, y = wave_pixel_coords(local, spp, width, jnp.int32(pix_base))
        jx, jy = rng.uniform2_soa(streams, 0)
        d = linalg.normalize(
            llc + right * (x + jx)[:, None] + up * (y + jy)[:, None]
        )
        o = jnp.broadcast_to(origin, d.shape)
        act = jnp.ones(size, bool)
        t, u, v, tri = nearest_hit_mxu(scene.mxu, o, d, act)
        o1, d1, _, _, _, missed, _ = shade_and_scatter(
            scene, o, d, t, u, v, tri, streams, 0
        )
        return (o, d, act, None), (o1, d1, ~missed, tri)

    return make(scene, *(jnp.asarray(v) for v in (
        camera.origin, camera.lower_left_corner, camera.right, camera.up)))


def _median_seconds(fn, reps: int = 5) -> float:
    """Median wall of ``reps`` synchronous calls of a warm device function."""
    import jax

    jax.block_until_ready(fn())
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[reps // 2]


def _backend_tolerance(tris, o, d, act, hits, n: int):
    """Per-ray |dt| allowance, beyond 1e-5 t, between two backends.

    t = -o'_w / d'_w (ops/mxu_intersect.py).  o'_w sums terms of size
    |o| / |n| that cancel, so a different rounding order (FMA contraction)
    moves it by a few ulps of |o| / |n|; d'_w = cos(theta) / |n|, so t
    moves by a few ulps of |o| over cos(theta), the incidence cosine of
    the hit triangle.  Inactive rays and misses get no allowance."""
    import numpy as np

    o, d, act = (np.asarray(x)[:n] for x in (o, d, act))
    data, perm = np.asarray(tris.tri_data), np.asarray(tris.perm)
    real = data[12] > 0
    slot = np.zeros(perm.max() + 1, np.int64)
    slot[perm[real]] = np.nonzero(real)[0]
    r_w = data[6:9, slot[hits[3]]].T  # n / |n|^2 of each ray's winner
    with np.errstate(invalid="ignore", divide="ignore"):
        cos = np.abs((d * r_w).sum(axis=1)) / np.linalg.norm(r_w, axis=1)
        ulps = 8 * np.spacing(np.abs(o).max(axis=1).astype(np.float32))
        tol = ulps / np.maximum(cos, 1e-3)
    return np.where(act & np.isfinite(hits[0]), tol, 0.0)


def phase_kernel(tmp: Path):
    import jax
    import numpy as np

    from zig_raytracing_contest_tpu.config import Config
    from zig_raytracing_contest_tpu.ops.mxu_intersect import nearest_hit_mxu
    from zig_raytracing_contest_tpu.ops.trace_kernel import nearest_hit_triton

    sys.path.insert(0, str(ROOT / "tests"))
    import test_trace_kernel as cases

    cpu = jax.devices("cpu")[0]
    config = Config(grid_resolution=(128, 128, 128), num_samples=3,
                    max_bounce=4)
    scan = jax.jit(nearest_hit_mxu)
    failures = []
    scenes = _scenes(tmp, config)
    for name, scene, camera in scenes:
        say(f"{name}: {scene.mxu.tri_data.shape[1]} bank slots, "
            f"{scene.shade_table.shape[0]} triangles")
        for wave_name, rays in zip(("primary", "bounce1"),
                                   wave_rays(scene, camera, 3)):
            o, d, act, excl = rays
            ref = jax.block_until_ready(scan(scene.mxu, o, d, act, excl))
            got = jax.block_until_ready(
                nearest_hit_triton(scene.mxu, o, d, act, excl))
            scan_s = _median_seconds(lambda: scan(scene.mxu, o, d, act, excl))
            kernel_s = _median_seconds(
                lambda: nearest_hit_triton(scene.mxu, o, d, act, excl))
            n = 4096
            sub = lambda x: None if x is None else jax.device_put(x[:n], cpu)
            with jax.default_device(cpu):
                ref_cpu = nearest_hit_mxu(
                    jax.device_put(scene.mxu, cpu), sub(o), sub(d),
                    sub(act), exclude=sub(excl))
            probs = cases.compare_hits(ref, got, exact=False)
            got_cpu = tuple(np.asarray(x)[:n] for x in got)
            tol = _backend_tolerance(scene.mxu, o, d, act, got_cpu, n)
            probs_cpu = cases.compare_hits(ref_cpu, got_cpu, exact=False,
                                           abs_tol=tol, self_band=SELF_BAND)
            band = int((np.minimum(np.asarray(ref_cpu[0]), got_cpu[0])
                        < SELF_BAND).sum())
            hits = int(np.isfinite(np.asarray(got[0])).sum())
            same = float((np.asarray(ref[3]) == np.asarray(got[3])).mean())
            say(f"  {wave_name}: {d.shape[0]} rays ({int(np.asarray(act).sum())}"
                f" active, {hits} hits): kernel {kernel_s * 1e3:.3f} ms, "
                f"jitted XLA scan {scan_s * 1e3:.3f} ms; winner agrees with "
                f"the XLA scan on {same:.6%} -> "
                f"{'PASS' if not probs else probs}; CPU backend on {n} rays "
                f"({band} self-hits below t = {SELF_BAND:g} set aside, |dt| "
                f"tolerance 1e-5 t + 8 ulp(|o|) / cos(incidence): median "
                f"{np.median(tol[tol > 0]) if (tol > 0).any() else 0:.2g}, "
                f"max {tol.max():.2g}) -> "
                f"{'PASS' if not probs_cpu else probs_cpu}")
            failures += [f"{name}/{wave_name}: {p}" for p in probs]
            failures += [f"{name}/{wave_name} vs CPU: {p}" for p in probs_cpu]
    name, scene, camera = scenes[0]
    say(f"render step ({name}, one wave) memory_analysis(): "
        f"{render_step_memory(scene, camera, config)}")
    for case in cases.CASES:
        probs = cases.check_case(case, interpret=False)
        say(f"  test case {cases._case_id(case)}: "
            f"{'PASS' if not probs else probs}")
        failures += [f"{cases._case_id(case)}: {p}" for p in probs]
    if failures:
        raise SmokeFailure("; ".join(failures))


def render_step_memory(scene, camera, config):
    """memory_analysis() of one compiled render chunk (one wave)."""
    import jax.numpy as jnp

    from zig_raytracing_contest_tpu.render.wavefront import (
        render_frame_chunk_emit,
    )

    spp = config.num_samples
    quantum = spp * 1024  # as render_scene quantizes its waves
    wave_size = min(config.wave_size, 1 << 23) // quantum * quantum
    fb = jnp.zeros((3, wave_size // spp), jnp.float32)
    cam = [jnp.asarray(v) for v in (camera.origin, camera.lower_left_corner,
                                    camera.right, camera.up)]
    compiled = render_frame_chunk_emit.lower(
        scene, fb, *cam, jnp.uint32(0), jnp.int32(0), camera.width, spp,
        config.max_bounce, wave_size, camera.width * camera.height, 1,
        jnp.int32(0),
    ).compile()
    return compiled.memory_analysis()


def run_cli(args: list[str]):
    """cli.main in-process; returns (wall s, the RenderStats it produced).

    The stats are taken from the render entry point cli.main calls (it
    imports it at call time), not parsed from its log lines."""
    from unittest import mock

    from zig_raytracing_contest_tpu import cli
    from zig_raytracing_contest_tpu.parallel import sharding
    from zig_raytracing_contest_tpu.render import pipeline

    seen = []

    def recording(fn):
        def wrapper(*a, **kw):
            seen.append(fn(*a, **kw))
            return seen[-1]
        return wrapper

    with mock.patch.object(pipeline, "render_file",
                           recording(pipeline.render_file)), \
            mock.patch.object(sharding, "render_file_sharded",
                              recording(sharding.render_file_sharded)):
        t0 = time.perf_counter()
        rc = cli.main(args)
        wall = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"cli.main returned {rc}")
    if len(seen) != 1:
        raise SmokeFailure(f"cli.main rendered {len(seen)} frames, not 1")
    return wall, seen[0]


def _official_inputs(tmp: Path) -> tuple[Path, Path]:
    sys.path.insert(0, str(ROOT))
    import bench

    scene = bench.build_bench_scene(tmp / "official.gltf")
    cfg = tmp / "config.json"
    cfg.write_text(json.dumps({"grid_resolution": [128, 128, 128],
                               "num_threads": None, "num_samples": 3,
                               "max_bounce": 4}))
    return scene, cfg


def _read_png(path: Path):
    from zig_raytracing_contest_tpu.utils.image_io import read_png

    return read_png(path.read_bytes())


def phase_main_path(tmp: Path, card: str):
    scene_path, cfg = _official_inputs(tmp)
    (w, h), spp = MAIN_SIZE, 3
    base = ["--in", str(scene_path), "--camera", "Camera 1", "--width",
            str(w), "--height", str(h), "--config", str(cfg)]
    rendered = []
    for run in ("first", "second"):
        out = tmp / f"main_{run}.png"
        wall, stats = run_cli(base + ["--out", str(out)])
        img = _read_png(out)
        if img.shape != (h, w, 3):
            raise SmokeFailure(f"PNG is {img.shape}, expected {(h, w, 3)}")
        if img.mean() < 5.0:
            raise SmokeFailure(f"image is black (mean {img.mean():.2f})")
        segments = stats.segments
        if segments <= w * h * spp:
            raise SmokeFailure(f"{segments} segments <= {w * h * spp} "
                               f"primaries")
        phases = stats.phases
        rendered.append(phases["render"])
        say(f"cli {run} run: {w}x{h}, {spp} spp, 4 bounces, {segments} "
            f"segments, image mean {img.mean():.2f}, wall {wall:.3f} s; "
            + ", ".join(f"{n} {v:.3f} s" for n, v in phases.items())
            + f"; {segments / phases['render'] / 1e6:.2f} Mrays/s on "
            f"{card}")
    say(f"cli: set-up (jit compile, or persistent-cache load) "
        f"{rendered[0] - rendered[1]:.3f} s = first Rendered - second; "
        f"steady render {rendered[1]:.3f} s")


def _golden_render(path: Path, spp: int, seed: int, grid: int = 16,
                   **camera_kw):
    """tests/test_golden.py's render of one asset, as an int array."""
    import numpy as np

    from zig_raytracing_contest_tpu.config import Config
    from zig_raytracing_contest_tpu.render.pipeline import (
        prepare_scene,
        render_scene,
    )

    cfg = Config(grid_resolution=(grid, grid, grid), num_samples=spp,
                 max_bounce=3, seed=seed)
    scene, cam, _ = prepare_scene(str(path), cfg, **camera_kw)
    img, _ = render_scene(scene, cam, cfg)
    return np.asarray(img).astype(int)


def _envelope(img, golden):
    diff = abs(img - golden)
    return float((diff > 3).mean()), float(diff.mean())


def _dilate(mask, r: int = 2):
    """Binary dilation with a (2r+1)^2 box, no edge wrap."""
    import numpy as np

    out = mask.copy()
    for axis in (0, 1):
        acc = out.copy()
        padded = np.pad(out, [(r, r) if a == axis else (0, 0)
                              for a in range(out.ndim)])
        for shift in range(1, r + 1):
            for off in (r - shift, r + shift):
                sl = [slice(None)] * out.ndim
                sl[axis] = slice(off, off + out.shape[axis])
                acc |= padded[tuple(sl)]
        out = acc
    return out


def _alpha_region_gate():
    """Region-aware bound for alpha_modes at 64 spp: outside the region
    where two CPU goldens of different seeds differ, near-exact; inside it,
    within the CPU seed-to-seed noise floor."""
    ref_a = _read_png(ASSETS / "golden64_alpha_modes.png").astype(int)
    ref_b = _read_png(ASSETS / "golden64_alpha_modes_s777.png").astype(int)
    seed_diff = abs(ref_a - ref_b)
    mask = _dilate(seed_diff.sum(axis=-1) > 0)
    floor = seed_diff[mask].mean()
    img = _golden_render(ASSETS / "alpha_modes.gltf", 64, 12345, width=128,
                         height=96)
    diff = img - ref_a
    adiff = abs(diff)
    out = adiff[~mask]
    out_mean = float(out.mean()) if out.size else 0.0
    out_max = int(out.max()) if out.size else 0
    in_mean = float(adiff[mask].mean())
    in_bias = float(diff[mask].mean())
    ok = (out_mean <= EXACT_MEAN_BOUND and out_max <= EXACT_MAX_BOUND
          and in_mean <= NOISE_MULT * floor and abs(in_bias) <= floor)
    say(f"  alpha_modes region gate at 64 spp: region {mask.mean():.1%}, "
        f"outside mean {out_mean:.4f} max {out_max}; inside mean "
        f"{in_mean:.2f} (bound {NOISE_MULT * floor:.2f}), bias "
        f"{in_bias:+.2f} (bound {floor:.2f}) -> {'PASS' if ok else 'FAIL'}")
    return ok


def phase_goldens(tmp: Path):
    sys.path.insert(0, str(ROOT / "scripts"))
    from duck_builder import write_duck_glb

    failures = []
    for name, path, grid, kw, golden in (
        ("duckish", ASSETS / "duckish.gltf", 16, dict(height=96),
         "golden_duckish.png"),
        ("alpha_modes", ASSETS / "alpha_modes.gltf", 16,
         dict(width=128, height=96), "golden_alpha_modes.png"),
        ("duck_glb", write_duck_glb(tmp / "duck.glb"), 32, dict(height=90),
         "golden_duck.png"),
    ):
        img = _golden_render(path, 4, 12345, grid, **kw)
        ref = _read_png(ASSETS / golden).astype(int)
        if img.shape != ref.shape:
            failures.append(f"{name}: shape {img.shape} != {ref.shape}")
            continue
        frac, mean = _envelope(img, ref)
        ok = frac < GOLDEN_FRAC and mean < GOLDEN_MEAN
        say(f"golden {name}: {frac:.4%} pixels off by >3 (bound "
            f"{GOLDEN_FRAC:.1%}), mean |diff| {mean:.3f} (bound "
            f"{GOLDEN_MEAN}) -> {'PASS' if ok else 'FAIL'}")
        if not ok and name == "alpha_modes":
            say("  alpha_modes is outside the plain envelope; applying the "
                "region-aware stochastic-alpha bound instead")
            ok = _alpha_region_gate()
        if not ok:
            failures.append(name)
    if failures:
        raise SmokeFailure(f"goldens failed: {failures}")


def phase_four(tmp: Path, card: str):
    """The official scene at 3840x2160 over four cards and on one card."""
    import jax
    import numpy as np

    if len(jax.devices()) < 4:
        raise SmokeFailure(f"--four needs 4 GPUs, found {len(jax.devices())}")
    scene_path, cfg = _official_inputs(tmp)
    base = ["--in", str(scene_path), "--camera", "Camera 1", "--width",
            str(FOUR_SIZE[0]), "--height", str(FOUR_SIZE[1]), "--config",
            str(cfg)]
    imgs = {}
    for label, extra in (("four", ["--devices", "4"]), ("one", [])):
        for run in ("first", "second"):  # cold (compiles), then warm
            out = tmp / f"4k_{label}.png"
            wall, stats = run_cli(base + ["--out", str(out)] + extra)
            render_s = stats.phases["render"]
            say(f"4K {label} card(s), {run} run: wall {wall:.3f} s, "
                f"{stats.segments} segments, render {render_s:.3f} s, "
                f"{stats.segments / render_s / 1e6:.2f} Mrays/s on {card}")
        imgs[label] = _read_png(out).astype(int)
    diff = abs(imgs["four"] - imgs["one"])
    differ = float((diff.sum(axis=-1) > 0).mean())
    if differ == 0.0:
        say("4K: four-card image is bit-identical to the one-card image")
        return
    frac, mean = float((diff > 3).mean()), float(diff.mean())
    say(f"4K: {differ:.4%} of pixels differ; {frac:.4%} by >3, mean "
        f"{mean:.4f}")
    if not (frac < GOLDEN_FRAC and mean < GOLDEN_MEAN):
        raise SmokeFailure("four-card image outside the golden envelope")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="only the 4-card sharded 4K phase")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)  # library INFO lines stay off
    try:
        devs = phase_device()
        card = card_line().replace("\n", " | ")
        with tempfile.TemporaryDirectory() as d:
            tmp = Path(d)
            steps = ([("four", lambda: phase_four(tmp, card))] if args.four
                     else [("kernel", lambda: phase_kernel(tmp)),
                           ("main path", lambda: phase_main_path(tmp, card)),
                           ("goldens", lambda: phase_goldens(tmp))])
            for name, step in steps:
                t0 = time.perf_counter()
                say(f"== phase {name}")
                step()
                say(f"== phase {name} passed in "
                    f"{time.perf_counter() - t0:.1f} s")
    except Exception as exc:  # every failure exits non-zero, no result line
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
