"""(Re)produce the committed CPU goldens (4 and 64 spp) under tests/assets/.

The jax CPU backend is the pinned oracle (see tests/test_golden.py); this
script forces it even when jax was imported with another platform as its
default.  Existing goldens are verified bit-identical rather than
overwritten (pass --overwrite to regenerate after an intentional change).

    python scripts/make_golden64.py [--overwrite]
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from zig_raytracing_contest_tpu.config import Config
from zig_raytracing_contest_tpu.render.pipeline import prepare_scene, render_scene
from zig_raytracing_contest_tpu.utils.image_io import read_png, write_png

ASSETS = Path(__file__).resolve().parent.parent / "tests" / "assets"

# (output name, scene, spp, seed, prepare_scene kwargs)
GOLDENS = [
    ("golden_duckish.png", "duckish", 4, 12345, dict(height=96)),
    ("golden_alpha_modes.png", "alpha_modes", 4, 12345,
     dict(width=128, height=96)),
    ("golden64_duckish.png", "duckish", 64, 12345, dict(height=96)),
    ("golden64_alpha_modes.png", "alpha_modes", 64, 12345,
     dict(width=128, height=96)),
    # Second seed of the same scene: chip_smoke.py's region-aware alpha
    # bound derives the stochastic-alpha region mask and the seed-to-seed
    # noise floor from the pair (bit-exact cross-backend agreement is not
    # possible in stochastic-alpha regions; see tests/test_golden.py).
    ("golden64_alpha_modes_s777.png", "alpha_modes", 64, 777,
     dict(width=128, height=96)),
]


def _check_or_write(out: Path, img, overwrite: bool) -> int:
    if out.exists() and not overwrite:
        ref = read_png(out.read_bytes())
        same = ref.shape == img.shape and (ref == img).all()
        print(f"{out.name}: exists, {'MATCHES' if same else 'DIFFERS'}")
        return int(not same)
    write_png(str(out), img)
    print(f"{out.name}: written")
    return 0


def main() -> int:
    overwrite = "--overwrite" in sys.argv
    assert jax.default_backend() == "cpu", jax.default_backend()
    rc = 0
    for out_name, scene_name, spp, seed, kw in GOLDENS:
        cfg = Config(grid_resolution=(16, 16, 16), num_samples=spp,
                     max_bounce=3, seed=seed)
        scene, cam, _ = prepare_scene(
            str(ASSETS / f"{scene_name}.gltf"), cfg, **kw)
        img, _ = render_scene(scene, cam, cfg)
        rc |= _check_or_write(ASSETS / out_name, img, overwrite)

    # Duck-class GLB golden (tests/test_golden.py::test_golden_duck_glb).
    import tempfile

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from duck_builder import write_duck_glb

    with tempfile.TemporaryDirectory() as td:
        glb = write_duck_glb(Path(td) / "duck.glb")
        cfg = Config(grid_resolution=(32, 32, 32), num_samples=4,
                     max_bounce=3, seed=12345)
        scene, cam, _ = prepare_scene(str(glb), cfg, height=90)
        img, _ = render_scene(scene, cam, cfg)
        rc |= _check_or_write(ASSETS / "golden_duck.png", img, overwrite)
    return rc


if __name__ == "__main__":
    sys.exit(main())
