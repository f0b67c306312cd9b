"""ctypes binding for the native C++ CPU tracer (native/cpu_tracer.cpp).

This is the stand-in for the reference Zig binary (whose toolchain
is not in this image): same algorithm — per-ray grid DDA + Möller–Trumbore +
textured diffuse path tracing over OS threads (reference:
src/stage3.zig:222-256) — driven by the same baked scene arrays as the device
renderer.  ``render_cpu`` produces the BASELINE.md denominator for the
"≥10× the CPU build" target and doubles as an independent correctness
oracle (tests/test_native_tracer.py).
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..scene.camera import Camera
from ..scene.types import DeviceScene

log = logging.getLogger("zig_raytracing_contest_tpu")

_SRC = Path(__file__).resolve().parent.parent / "native" / "cpu_tracer.cpp"
_LIB_PATH = Path(__file__).resolve().parent.parent / "native" / "libzrctracer.so"
_lock = threading.Lock()
_lib = None

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)


def load_library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
            cmd = [
                "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                str(_SRC), "-o", str(_LIB_PATH),
            ]
            log.info("Building native CPU tracer: %s", " ".join(cmd))
            subprocess.run(cmd, check=True, capture_output=True)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.zrc_cpu_render.restype = ctypes.c_int64
        lib.zrc_cpu_render.argtypes = [
            _f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_uint32, _f32p, _f32p, _i32p, _i32p,
            _i32p, _f32p, _f32p, _f32p, _i32p, _f32p, _f32p, ctypes.c_int32,
            _f32p,
        ]
        _lib = lib
        return lib


def _c(a, dtype):
    return np.ascontiguousarray(np.asarray(a), dtype)


def render_cpu(
    scene: DeviceScene,
    camera: Camera,
    spp: int,
    max_bounce: int,
    seed: int = 0,
    num_threads: int = 0,  # 0 = OpenMP default (all cores)
):
    """Render on the host CPU.  Returns (img_u8 (h, w, 3), segments, seconds).

    The gamma encode reuses the jax-side vec3_to_rgb for bitwise-identical
    quantization with the device renderers.
    """
    from ..ops import linalg

    lib = load_library()
    w, h = camera.width, camera.height
    cam = np.concatenate(
        [camera.origin, camera.lower_left_corner, camera.right, camera.up]
    ).astype(np.float32)
    fb = np.zeros((h * w, 3), np.float32)

    args = dict(
        bbox_min=_c(scene.grid.bbox_min, np.float32),
        cell_size=_c(scene.grid.cell_size, np.float32),
        resolution=_c(scene.grid.resolution, np.int32),
        cell_begin=_c(scene.cell_begin, np.int32),
        cell_end=_c(scene.cell_end, np.int32),
        tri_v0=_c(scene.tri_v0, np.float32),
        tri_e1=_c(scene.tri_e1, np.float32),
        tri_e2=_c(scene.tri_e2, np.float32),
        dup_to_tri=_c(scene.dup_to_tri, np.int32),
        shade_table=_c(scene.shade_table, np.float32),
        color_data=_c(scene.color_data, np.float32),
    )
    t0 = time.perf_counter()
    segments = lib.zrc_cpu_render(
        cam.ctypes.data_as(_f32p),
        w, h, spp, max_bounce, ctypes.c_uint32(seed),
        args["bbox_min"].ctypes.data_as(_f32p),
        args["cell_size"].ctypes.data_as(_f32p),
        args["resolution"].ctypes.data_as(_i32p),
        args["cell_begin"].ctypes.data_as(_i32p),
        args["cell_end"].ctypes.data_as(_i32p),
        args["tri_v0"].ctypes.data_as(_f32p),
        args["tri_e1"].ctypes.data_as(_f32p),
        args["tri_e2"].ctypes.data_as(_f32p),
        args["dup_to_tri"].ctypes.data_as(_i32p),
        args["shade_table"].ctypes.data_as(_f32p),
        args["color_data"].ctypes.data_as(_f32p),
        num_threads,
        fb.ctypes.data_as(_f32p),
    )
    seconds = time.perf_counter() - t0
    img = np.asarray(linalg.vec3_to_rgb(fb / spp)).reshape(h, w, 3)
    return img, int(segments), seconds
