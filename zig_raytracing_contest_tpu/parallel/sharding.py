"""Multi-chip rendering: pixel-tile data parallelism over a device mesh.

The reference's only render parallelism is fork-join OS threads over
contiguous pixel blocks with zero communication (src/stage3.zig:222-256).
The device equivalent (SURVEY.md §2): a 1D ``jax.sharding.Mesh`` over
devices, ``shard_map`` with the framebuffer sharded by pixel tile and the
scene (read-only) replicated.  Each device renders exactly the global ray
ids of its own pixel tile, so the per-ray counter RNG makes the
multi-device image bit-identical to the single-device one; the only
collective is the gather of the sharded framebuffer at the end, nothing
in the hot loop.
"""

from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Config
from ..ops import linalg
from ..scene.camera import Camera
from ..scene.types import DeviceScene
from ..utils.image_io import write_png
from ..utils.timing import PhaseTimers
from ..render.pipeline import RenderStats, prepare_scene
from ..render.wavefront import render_wave_rows

log = logging.getLogger("zig_raytracing_contest_tpu")


def make_mesh(num_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} visible")
    return Mesh(np.asarray(devices[:n]), ("tiles",))


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "width",
        "spp",
        "max_bounce",
        "wave_size",
        "num_slots",
        "slots_per_dev",
        "waves_per_dev",
        "ext",
    ),
)
def _render_sharded(
    scene: DeviceScene,
    fb,  # (3, n * cols_per_dev) field-major, sharded along axis 1
    cam_origin,
    cam_lower_left,
    cam_right,
    cam_up,
    base_key,
    *,
    mesh: Mesh,
    width: int,
    spp: int,
    max_bounce: int,
    wave_size: int,
    num_slots: int,
    slots_per_dev: int,
    waves_per_dev: int,
    ext=None,
):
    wave_pixels = wave_size // spp

    def tile_fn(scene, fb_local, cam_origin, cam_lower_left, cam_right, cam_up, base_key):
        dev = jax.lax.axis_index("tiles")
        slot0 = dev * slots_per_dev
        # Rows past this device's tile or the real slot space are zeroed by
        # render_wave_rows (slot_cap), so a final wave may spill into the
        # padded framebuffer columns harmlessly.
        slot_cap = jnp.minimum(slot0 + slots_per_dev, num_slots).astype(
            jnp.int32
        )
        cam = (cam_origin, cam_lower_left, cam_right, cam_up)

        def wave_body(w, carry):
            fb, segs = carry
            # slot bases in exact int32 — a far device tile of a large
            # image exceeds f32's 2^24 integer range.
            slot_base = (slot0 + w * wave_pixels).astype(jnp.int32)
            rows3, wave_segs = render_wave_rows(
                scene, cam, width, spp, max_bounce, slot_base, slot_cap,
                wave_size, base_key, ext,
            )
            sums = rows3.reshape(3, wave_pixels, spp).sum(axis=2)
            lp0 = w * wave_pixels
            cur = jax.lax.dynamic_slice(fb, (0, lp0), (3, wave_pixels))
            fb = jax.lax.dynamic_update_slice(fb, cur + sums, (0, lp0))
            return fb, segs + wave_segs

        fb_local, segs = jax.lax.fori_loop(
            0, waves_per_dev, wave_body, (fb_local, jnp.int32(0))
        )
        return fb_local, segs[None]

    scene_spec = jax.tree.map(lambda _: P(), scene)
    return jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(scene_spec, P(None, "tiles"), P(), P(), P(), P(), P()),
        out_specs=(P(None, "tiles"), P("tiles")),
        # check_vma must stay off, precisely because every loop carry in the
        # renderer (nearest_hit_xla's scan best-t/idx, trace_wave's
        # while_loop state, wave_body's segment counter) initializes from
        # literals: VMA types them "unvarying", the first iteration makes
        # them device-varying, and jax raises "carry input and carry output
        # must have equal types" (verified r2 with check_vma=True).  Seeding
        # the carries from varying data would insert real ops in the hot
        # loop just to satisfy the checker.  Correctness is pinned instead
        # by tests/test_sharding.py: sharded output is bit-identical to
        # single-device, for the XLA scan and for the trace kernel.
        check_vma=False,
    )(scene, fb, cam_origin, cam_lower_left, cam_right, cam_up, base_key)


def render_scene_sharded(
    scene: DeviceScene,
    camera: Camera,
    config: Config,
    mesh: Mesh | None = None,
    timers: PhaseTimers | None = None,
):
    """Multi-device render; bit-identical to the single-device path."""
    timers = timers or PhaseTimers()
    ext = config.ext_flags
    if not ext.any:
        ext = None
    mesh = mesh or make_mesh()
    n = mesh.devices.size
    w, h, spp = camera.width, camera.height, config.num_samples
    num_pixels = w * h
    if num_pixels * spp >= 1 << 31:
        raise ValueError(
            f"{num_pixels} pixels × {spp} spp = {num_pixels * spp} rays "
            f"exceeds the int32 ray-id space (2^31); reduce resolution or spp."
        )
    num_slots = num_pixels
    # Raster order, one contiguous pixel range per device (the reference's
    # arbitrary contiguous split).
    slots_per_dev = -(-num_slots // n)
    rays_per_dev = slots_per_dev * spp
    # Wave quantum: spp (whole pixels → scatter-free accumulation) × 1024
    # (the trace kernel's ray blocks divide every wave).
    quantum = spp * 1024
    wave_size = max(
        quantum,
        min(config.wave_size, rays_per_dev + quantum - 1) // quantum * quantum,
    )
    # Exact-f32 wave-local ray math bounds a wave at 2^23 rays (see
    # render/pipeline.py).
    wave_size = min(wave_size, (1 << 23) // quantum * quantum)
    waves_per_dev = -(-rays_per_dev // wave_size)
    # Per-device framebuffer columns padded to whole waves.
    fb_cols_per_dev = waves_per_dev * (wave_size // spp)
    log.info(
        "Num samples: %d, max bounce %d", config.num_samples, config.max_bounce
    )
    log.info(
        "Mesh: %d device(s), %d slots/device, %d wave(s) of %d rays",
        n, slots_per_dev, waves_per_dev, wave_size,
    )

    fb_sharding = NamedSharding(mesh, P(None, "tiles"))
    fb = jnp.zeros((3, fb_cols_per_dev * n), jnp.float32, device=fb_sharding)
    replicated = NamedSharding(mesh, P())
    scene = jax.device_put(scene, replicated)

    with timers.phase("render", "Rendered"):
        fb, segs = _render_sharded(
            scene,
            fb,
            jax.device_put(jnp.asarray(camera.origin), replicated),
            jax.device_put(jnp.asarray(camera.lower_left_corner), replicated),
            jax.device_put(jnp.asarray(camera.right), replicated),
            jax.device_put(jnp.asarray(camera.up), replicated),
            jax.device_put(jnp.uint32(config.seed), replicated),
            mesh=mesh,
            width=w,
            spp=spp,
            max_bounce=config.max_bounce,
            wave_size=wave_size,
            num_slots=num_slots,
            slots_per_dev=slots_per_dev,
            waves_per_dev=waves_per_dev,
            ext=ext,
        )
        # Strip per-device padding, then global padding.
        fb_np = np.asarray(fb).reshape(3, n, fb_cols_per_dev)[
            :, :, :slots_per_dev
        ].reshape(3, -1)[:, :num_pixels]
        img = np.asarray(
            linalg.vec3_to_rgb(jnp.asarray(fb_np.T) / spp)
        ).reshape(h, w, 3)
        segments = int(np.asarray(segs).sum())

    stats = RenderStats(
        width=w, height=h, spp=spp, max_bounce=config.max_bounce,
        segments=segments, phases=timers.phases,
    )
    return img, stats


def render_file_sharded(
    in_path: str,
    out_path: str,
    config: Config,
    camera_name=None,
    width=None,
    height=None,
    num_devices: int | None = None,
) -> RenderStats:
    scene, camera, timers = prepare_scene(in_path, config, camera_name, width, height)
    img, stats = render_scene_sharded(
        scene, camera, config, make_mesh(num_devices), timers
    )
    with timers.phase("save", "Saved"):
        write_png(out_path, img)
    timers.done()
    stats.phases = timers.phases
    return stats
