"""End-to-end render pipeline: scene file → PNG, with phase timing.

The orchestration mirror of the reference's main() (src/main.zig:73-143):
load → preprocess → compile → render → save, each phase timed and logged.
"compile" is the grid build and bake (the reference's meaning); the jit
compile of the first chunk lands in "render" on a cold compile cache.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..grid.builder import build_grid
from ..ops import linalg
from ..scene.camera import Camera, load_camera
from ..scene.geometry import load_geometry
from ..scene.gltf import load_gltf
from ..scene.materials import load_materials
from ..scene.types import DeviceScene, build_device_scene
from ..utils.image_io import write_png
from ..utils.timing import PhaseTimers
from .wavefront import render_frame_chunk_emit, render_wave_accumulate_rows

# Upper bound on waves per device call: chunks keep the frame's device→host
# transfers overlapped with later chunks' compute (see _chunk_plan).
WAVES_PER_CALL = 64


def _chunk_plan(num_waves: int, cap: int = WAVES_PER_CALL) -> list[int]:
    """Descending power-of-two chunk sizes: early chunks are big so their
    u8 transfers ride under later chunks' compute, and the LAST chunk is
    one wave so the only exposed device→host bytes are ~1/num_waves of
    the image.  Power-of-two sizes keep the number of DISTINCT sizes — and
    therefore of compiled chunk programs — logarithmic."""
    plan = []
    rem = num_waves
    while rem > 0:
        c = min(cap, 1 << max(0, rem.bit_length() - 2))
        plan.append(c)
        rem -= c
    return plan

log = logging.getLogger("zig_raytracing_contest_tpu")


@partial(jax.jit, static_argnames=("num_pixels", "spp"))
def _finalize_image_rows(fb, num_pixels: int, spp: int):
    """Frame epilogue in one device call: average samples, gamma-encode.
    Returns the image flat (num_pixels*3,) u8."""
    return linalg.vec3_to_rgb(fb[:, :num_pixels].T / spp).reshape(-1)


@dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    max_bounce: int
    segments: int  # traced path segments (= rays for Mrays/s)
    phases: dict


def prepare_scene(in_path: str, config: Config, camera_name=None, width=None, height=None):
    """Host pipeline: parse, extract, build grid, upload. Returns
    (DeviceScene, Camera, timers)."""
    timers = PhaseTimers()

    with timers.phase("load", "Loaded"):
        gltf = load_gltf(in_path, num_threads=config.host_threads)

    with timers.phase("preprocess", "Preprocessed"):
        camera = load_camera(gltf, camera_name, width, height)
        log.info("Pixels count: %d", camera.width * camera.height)
        materials = load_materials(gltf)
        log.info("Materials count: %d", materials.num_materials)
        geometry = load_geometry(gltf)
        if config.debug_checks and geometry.num_triangles:
            for name in ("positions", "normals", "texcoords"):
                arr = getattr(geometry, name)
                bad = int(np.sum(~np.isfinite(arr)))
                if bad:
                    raise FloatingPointError(
                        f"debug_checks: {bad} non-finite {name} values in "
                        f"loaded geometry"
                    )

    with timers.phase("compile", "Compiled"):
        try:
            from ..grid.native import build_grid_native

            grid = build_grid_native(
                geometry.positions, config.grid_resolution, log_fn=log.info
            )
        except Exception as exc:  # no C++ toolchain → NumPy reference builder
            log.warning("native grid builder unavailable (%s); using NumPy", exc)
            grid = build_grid(geometry.positions, config.grid_resolution, log=log.info)
        scene = build_device_scene(geometry, grid, materials, backend=config.backend)
        log.info(
            "Intersection backend: %s",
            "brute force over the baked bank" if scene.mxu is not None
            else "grid DDA",
        )

    return scene, camera, timers


def render_scene(
    scene: DeviceScene,
    camera: Camera,
    config: Config,
    timers: PhaseTimers | None = None,
    progressive_path: str | None = None,
) -> tuple[np.ndarray, RenderStats]:
    """Render to an (h, w, 3) uint8 array, looping jitted waves on device."""
    timers = timers or PhaseTimers()
    w, h, spp = camera.width, camera.height, config.num_samples
    num_pixels = w * h
    total_rays = num_pixels * spp
    if total_rays >= 1 << 31:
        # Global ray ids are int32 (pixel bases are exact int32; only the
        # per-wave offsets use f32 math).  u16×u16 dims × sane spp fit:
        # even 65535×65535 needs spp=1; 8K×8K at spp≤500 is fine.
        raise ValueError(
            f"{num_pixels} pixels × {spp} spp = {total_rays} rays exceeds "
            f"the int32 ray-id space (2^31); reduce resolution or spp."
        )
    ext = config.ext_flags
    if not ext.any:
        ext = None
    # Waves are quantized to spp*1024 rays: multiples of spp so every wave
    # covers whole pixels (scatter-free accumulation) and of 1024 so the
    # trace kernel's ray blocks divide every wave.
    quantum = spp * 1024
    wave_size = max(
        quantum, min(config.wave_size, total_rays + quantum - 1) // quantum * quantum
    )
    # Wave-local ray ids use exact-f32 divmod: cap at 2^23 (a user-set
    # wave_size past that would silently corrupt pixel indices).
    wave_size = min(wave_size, (1 << 23) // quantum * quantum)
    num_waves = -(-total_rays // wave_size)
    wave_pixels = wave_size // spp
    fb_cols = num_waves * wave_pixels  # padded framebuffer (pixel-major)
    log.info(
        "Num samples: %d, max bounce %d", config.num_samples, config.max_bounce
    )

    cam = tuple(
        jnp.asarray(v)
        for v in (camera.origin, camera.lower_left_corner, camera.right,
                  camera.up)
    )
    base_key = jnp.uint32(config.seed)
    fb = jnp.zeros((3, fb_cols), jnp.float32)
    progressive = progressive_path and config.progressive_every

    with timers.phase("render", "Rendered"):
        if not progressive:
            # fori_loop chunks, one device call per chunk.  Each chunk also
            # emits its finished pixels as u8 and starts the device→host
            # copy at once, so transfers overlap later chunks' compute.
            segs = jnp.int32(0)
            pieces = []
            start = 0
            for chunk in _chunk_plan(num_waves):
                fb, enc, segs = render_frame_chunk_emit(
                    scene, fb, *cam, base_key, segs, w, spp,
                    config.max_bounce, wave_size, num_pixels, chunk,
                    jnp.int32(start), ext,
                )
                enc.copy_to_host_async()
                pieces.append((start * wave_pixels, enc))
                start += chunk
        else:
            seg_parts = []  # device scalars; converting per-wave would sync
            for wave in range(num_waves):
                fb, wave_segments = render_wave_accumulate_rows(
                    scene, fb, *cam, base_key, jnp.int32(wave), w, spp,
                    config.max_bounce, wave_size, num_pixels, ext,
                )
                seg_parts.append(wave_segments)
                if (wave + 1) % config.progressive_every == 0 and (
                    wave + 1 < num_waves
                ):
                    # Progressive dump: pixels not yet reached stay dark.
                    partial_px = np.asarray(
                        _finalize_image_rows(fb, num_pixels, spp)
                    )
                    write_png(progressive_path, partial_px.reshape(h, w, 3))
        if config.debug_checks:
            # Debug mode (SURVEY §5; reference Debug/ReleaseSafe analogue,
            # build.zig:16): a NaN/Inf in accumulated radiance would clamp
            # silently at gamma encode — surface it as a typed failure with
            # the offending sample count instead.
            bad = int(jnp.sum(~jnp.isfinite(fb)))
            if bad:
                raise FloatingPointError(
                    f"debug_checks: {bad} non-finite framebuffer channel "
                    f"values before PNG encode"
                )
        if not progressive:
            # Streaming assembly: fetch each chunk's u8 slice (blocks until
            # that chunk's async copy lands) while later chunks may still
            # be computing.  The last 4 bytes of the final piece carry the
            # running segment total.
            img = np.empty((fb_cols, 3), np.uint8)
            segments = 0
            for pix0, enc in pieces:
                buf = np.asarray(enc)
                segments = int(np.frombuffer(buf[-4:].tobytes(), np.int32)[0])
                data = buf[:-4].reshape(-1, 3)
                img[pix0 : pix0 + data.shape[0]] = data
            img = img[:num_pixels].reshape(h, w, 3)
        else:
            img = np.asarray(
                _finalize_image_rows(fb, num_pixels, spp)
            ).reshape(h, w, 3)
            segments = int(
                np.sum([int(sp) for sp in seg_parts], dtype=np.int64)
            )

    stats = RenderStats(
        width=w,
        height=h,
        spp=spp,
        max_bounce=config.max_bounce,
        segments=segments,
        phases=timers.phases,
    )
    return img, stats


def render_file(
    in_path: str,
    out_path: str,
    config: Config,
    camera_name=None,
    width=None,
    height=None,
) -> RenderStats:
    """Full reference-equivalent run: scene file in, PNG out."""
    scene, camera, timers = prepare_scene(in_path, config, camera_name, width, height)
    progressive = out_path if config.progressive_every else None
    img, stats = render_scene(scene, camera, config, timers, progressive)
    with timers.phase("save", "Saved"):
        write_png(out_path, img)
    timers.done()
    stats.phases = timers.phases
    return stats
