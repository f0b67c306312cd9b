"""Platform-level choices: which trace runs where, where compiled programs
are cached, and that the on-card smoke test refuses to run without a card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import zig_raytracing_contest_tpu as pkg
from zig_raytracing_contest_tpu.ops.mxu_intersect import nearest_hit_mxu
from zig_raytracing_contest_tpu.ops.trace_kernel import nearest_hit_triton
from zig_raytracing_contest_tpu.render.wavefront import select_trace

ROOT = Path(__file__).resolve().parent.parent


def test_gpu_traces_with_the_triton_kernel():
    assert select_trace("gpu") is nearest_hit_triton


def test_cpu_traces_with_the_xla_scan():
    assert select_trace("cpu") is nearest_hit_mxu


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="platform"):
        select_trace(platform)


def test_cache_dir_honours_the_environment(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "c")}
    assert pkg.compilation_cache_dir(env) == str(tmp_path / "c")


def test_cache_dir_defaults_inside_the_checkout():
    path = pkg.compilation_cache_dir({})
    assert path == str(ROOT / ".jax_cache")
    assert path == pkg.compilation_cache_dir({})  # fixed, not per process


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, timeout=300, cwd=ROOT, env=env,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr
