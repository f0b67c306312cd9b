"""Wavefront path tracer: the reference's recursive per-pixel loop
(src/stage3.zig:188-256) re-architected as bounce rounds over a flat ray wave.

Every bounce is one vectorized round over (R,) rays carrying radiance /
throughput / alive accumulators; the unrolled bounce loop reproduces
``emissive + albedo * recurse(depth-1)`` as ``radiance += throughput *
emissive; throughput *= albedo`` and the stochastic-alpha pass-through
(src/stage3.zig:207-213: same direction, origin offset by t + FLT_EPSILON,
consumes a bounce) as a masked direction hold.  Continuation traces exclude
the previous hit triangle (ops.mxu_intersect.EXCLUDE_PREV_HIT): the
reference's nudge is a rounding no-op at t >= 2, so same-triangle re-hits
are phantom by construction and backend-rounding-dependent — excluding
them makes renders deterministic across backends.

The trace is ``trace_any``: brute force over the baked bank (the Triton
kernel on the GPU, the XLA tile scan on the CPU) or the grid DDA below;
shading is plain XLA (``shade_and_scatter``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dda, linalg, rng
from ..ops.texture import sample_texture
from ..scene.types import DeviceScene

FLT_EPSILON = float(jnp.finfo(jnp.float32).eps)  # std.math.floatEps(f32)
INF = jnp.inf

# Triangles tested per ray per while-loop iteration in the grid DDA.
TRI_BATCH = 4


class TraceResult(NamedTuple):
    t: jnp.ndarray  # (R,) f32 — +inf on miss
    u: jnp.ndarray  # (R,) f32
    v: jnp.ndarray  # (R,) f32
    dup_idx: jnp.ndarray  # (R,) int32 — index into duplicated tri arrays


def select_trace(platform: str):
    """The nearest-hit implementation for BVH-baked scenes on ``platform``
    (``jax.default_backend()``): the Triton kernel on the GPU, the XLA tile
    scan on the CPU.  Both take (tris, orig, direction, active, exclude)
    and return (t, u, v, unique_tri_idx)."""
    if platform == "gpu":
        from ..ops.trace_kernel import nearest_hit_triton

        return nearest_hit_triton
    if platform == "cpu":
        from ..ops.mxu_intersect import nearest_hit_mxu

        return nearest_hit_mxu
    raise ValueError(
        f"no trace implementation for platform {platform!r} (gpu or cpu)"
    )


def trace_any(scene: DeviceScene, orig, direction, active, exclude=None):
    """Backend dispatch: returns (t, u, v, unique_tri_idx).

    Brute force over the baked bank when the scene has one (scene.mxu;
    implementation chosen by select_trace from the platform), else the
    grid DDA.  Both implement the same hit rule; visibility is identical
    by construction (the grid only prunes work, never hits).

    ``exclude``: optional (R,) int32 unique-space previous-hit triangle
    each ray may not re-hit (ops.mxu_intersect.EXCLUDE_PREV_HIT).
    """
    if scene.mxu is not None:
        trace = select_trace(jax.default_backend())
        return trace(scene.mxu, orig, direction, active, exclude)
    hit = trace_wave(scene, orig, direction, active, exclude=exclude)
    return hit.t, hit.u, hit.v, scene.dup_to_tri[hit.dup_idx]


def trace_wave(scene: DeviceScene, orig, direction, active,
               exclude=None) -> TraceResult:
    """Nearest-hit for a wave of rays via grid DDA + Möller–Trumbore.

    Reference: Scene.traceRay (src/stage3.zig:152-186).  ``active=False``
    rays return a miss without touching memory bandwidth beyond lock-step.
    ``exclude`` is in UNIQUE triangle space (the grid's candidates are
    duplicated per cell, so each is mapped through dup_to_tri to compare).
    """
    entered, state = dda.dda_setup(scene.grid, orig, direction)

    cell_lin = dda.linearize_cell_idx(scene.grid, state.cell)
    cell_lin = jnp.clip(cell_lin, 0, scene.cell_begin.shape[0] - 1)
    cursor = jnp.where(entered, scene.cell_begin[cell_lin], 0)
    cur_end = jnp.where(entered, scene.cell_end[cell_lin], 0)

    nearest_t = jnp.full(orig.shape[:-1], INF, jnp.float32)
    nearest_u = jnp.zeros_like(nearest_t)
    nearest_v = jnp.zeros_like(nearest_t)
    nearest_i = jnp.zeros_like(cursor)
    done = ~(entered & active)

    def cond(carry):
        done = carry[0]
        return ~jnp.all(done)

    def body(carry):
        (done, state, cursor, cur_end, nearest_t, nearest_u, nearest_v, nearest_i) = carry
        alive = ~done

        # --- triangle phase: up to TRI_BATCH MT tests against current cell
        for _ in range(TRI_BATCH):
            has_tri = alive & (cursor < cur_end)
            idx = jnp.where(has_tri, cursor, 0)
            valid, t, u, v = linalg.moller_trumbore(
                orig, direction, scene.tri_v0[idx], scene.tri_e1[idx], scene.tri_e2[idx]
            )
            better = has_tri & valid & (t > 0.0) & (t < nearest_t)
            if exclude is not None:
                better = better & (scene.dup_to_tri[idx] != exclude)
            nearest_t = jnp.where(better, t, nearest_t)
            nearest_u = jnp.where(better, u, nearest_u)
            nearest_v = jnp.where(better, v, nearest_v)
            nearest_i = jnp.where(better, idx, nearest_i)
            cursor = cursor + has_tri.astype(jnp.int32)

        # --- cell-advance phase: rays whose cell is exhausted step the DDA
        need_advance = alive & (cursor >= cur_end)
        t_cross, state = dda.dda_next(state, active=need_advance)
        # Early exit: hit settled before the next cell boundary, or grid
        # exit (t_cross = inf; inf <= inf also terminates, matching Zig).
        newly_done = need_advance & (nearest_t <= t_cross)
        done = done | newly_done

        moved = need_advance & ~newly_done
        cell_lin = dda.linearize_cell_idx(scene.grid, state.cell)
        cell_lin = jnp.clip(cell_lin, 0, scene.cell_begin.shape[0] - 1)
        cursor = jnp.where(moved, scene.cell_begin[cell_lin], cursor)
        cur_end = jnp.where(moved, scene.cell_end[cell_lin], cur_end)

        return (done, state, cursor, cur_end, nearest_t, nearest_u, nearest_v, nearest_i)

    carry = (done, state, cursor, cur_end, nearest_t, nearest_u, nearest_v, nearest_i)
    carry = jax.lax.while_loop(cond, body, carry)
    (_, _, _, _, nearest_t, nearest_u, nearest_v, nearest_i) = carry
    return TraceResult(nearest_t, nearest_u, nearest_v, nearest_i)


def _interpolate(per_vertex, u, v):
    """Barycentric interpolation: v0*(1-u-v) + v1*u + v2*v.

    (src/stage3.zig:53-71 — Triangle.Data.interpolate).
    per_vertex: (R, 3, C); u, v: (R,).
    """
    w0 = (1.0 - u - v)[:, None]
    return per_vertex[:, 0] * w0 + per_vertex[:, 1] * u[:, None] + per_vertex[:, 2] * v[:, None]


def _exact_divmod_f32(g, d: int):
    """(g // d, g % d) for 0 <= g < 2^23 via exact f32 math — no int div.

    f32 represents every int < 2^24; a reciprocal-multiply can be off by one
    at boundaries, fixed with compares.
    """
    gf = g.astype(jnp.float32)
    q = jnp.floor(gf * jnp.float32(1.0 / d))
    q = jnp.where(q * d > gf, q - 1.0, q)
    q = jnp.where((q + 1.0) * d <= gf, q + 1.0, q)
    return q, gf - q * d


def wave_pixel_coords(local, spp, width: int, pix_base):
    """(pixel int32, x f32, y f32) for wave-local ray ids.

    ``pix_base`` (scalar int32, the wave's first pixel id) is split exactly
    with ONE scalar integer divmod; the per-ray offsets — bounded by
    wave_size/spp + width < 2^23 — use exact f32 math.  Exact for any
    pix_base < 2^31, i.e. images far past
    4K and device tiles whose base exceeds f32's 2^24 integer range.
    Pixel x/y follow the reference's row-major convention
    (src/stage3.zig:234-235).
    """
    pix_base = jnp.asarray(pix_base, jnp.int32)
    y_base = pix_base // width  # scalar, once per wave
    x_base = pix_base - y_base * width
    lp_f, _ = _exact_divmod_f32(local, spp)
    pixel = pix_base + lp_f.astype(jnp.int32)
    row_off = x_base.astype(jnp.float32) + lp_f
    dy, x = _exact_divmod_f32(row_off, width)
    y = y_base.astype(jnp.float32) + dy
    return pixel, x, y


def shade_and_scatter(scene: DeviceScene, orig, direction, t, u, v, tri, streams, bounce: int):
    """One shading round: texture fetch, alpha test, diffuse scatter.

    ``tri`` indexes the unique triangle attribute arrays.  Returns
    (new_orig, new_dir, emissive_term, albedo_term, opacity_pass, missed) —
    all gated downstream by the caller's alive mask.
    Reference: traceRayRecursive body (src/stage3.zig:188-220).
    """
    missed = t == INF

    # ONE fat gather per ray: normals + uvs + both texture descriptors
    # (scene/types.py shade_table layout).
    from ..scene.types import COL_BASE_DESC, COL_EMIS_DESC

    rec = scene.shade_table[tri]  # (R, 32)
    tri_nrm = rec[:, 0:9].reshape(-1, 3, 3)
    tri_uv = rec[:, 9:15].reshape(-1, 3, 2)
    base_desc = rec[:, COL_BASE_DESC : COL_BASE_DESC + 7]
    emis_desc = rec[:, COL_EMIS_DESC : COL_EMIS_DESC + 7]

    texcoord = _interpolate(tri_uv, u, v)
    tc_u, tc_v = texcoord[:, 0], texcoord[:, 1]
    base = sample_texture(scene.color_data, base_desc, tc_u, tc_v)  # (R, 4)
    albedo = base[:, :3]
    opacity = base[:, 3]  # reference's "transparency" texture == base alpha
    emissive = sample_texture(scene.color_data, emis_desc, tc_u, tc_v)[:, :3]
    normal = _interpolate(tri_nrm, u, v)

    # Stochastic alpha: rand > opacity → continue straight through
    # (src/stage3.zig:207-213).  Both branches consume a bounce.
    rnd = rng.uniform(streams, 2 * bounce + 1)
    pass_through = rnd > opacity

    # Diffuse bounce: dir = normalize(normal + randomUnitVector)
    # (src/stage3.zig:214-217; Gaussian sphere sampling src/linalg.zig:140-148).
    gauss = rng.normal3(streams, 2 * bounce + 2)
    scattered = linalg.normalize(normal + linalg.normalize(gauss))

    new_orig = linalg.ray_at(orig, direction, t + FLT_EPSILON)
    new_dir = jnp.where(pass_through[:, None], direction, scattered)

    return new_orig, new_dir, emissive, albedo, pass_through, missed, normal


def render_wave(
    scene: DeviceScene,
    cam_origin,
    cam_lower_left,
    cam_right,
    cam_up,
    width: int,
    spp: int,
    max_bounce: int,
    g_start,
    wave_size: int,
    base_key,
    pix_base=None,
    ext=None,
):
    """Path-trace one wave of global ray ids [g_start, g_start + wave_size).

    Global ray id g ↔ (pixel = g // spp, sample = g % spp); pixel x/y from
    the row-major index like the reference (src/stage3.zig:234-235).
    ``pix_base`` is the exact int32 pixel id of the wave's first ray
    (= g_start // spp; waves are pixel-aligned).  It is a separate argument
    because g_start need not be f32-representable (sharded tiles of large
    images exceed 2^24), while int32 is exact to 2^31 rays.  Defaults to
    g_start // spp (one scalar int div per wave — cold).
    Returns (pixel_ids (R,), radiance (R, 3), segments (R,) int32) where
    segments counts traced path segments for the Mrays/s metric.
    """
    R = wave_size
    local = jnp.arange(R, dtype=jnp.int32)
    g = g_start + local
    streams = rng.ray_streams(base_key, g)

    if pix_base is None:
        pix_base = g_start // spp
    pixel, x, y = wave_pixel_coords(local, spp, width, pix_base)

    jx, jy = rng.uniform2_soa(streams, 0)
    sx = x + jx
    sy = y + jy

    ext_any = ext is not None and ext.any
    direction = linalg.normalize(
        cam_lower_left + cam_right * sx[:, None] + cam_up * sy[:, None]
    )
    orig = jnp.broadcast_to(cam_origin, direction.shape)
    alive = jnp.ones(R, dtype=bool)
    segments = jnp.zeros(R, dtype=jnp.int32)
    radiance = jnp.zeros_like(direction)
    throughput = jnp.ones_like(direction)
    # NEE bookkeeping: emissive hit radiance counts only when the previous
    # segment was NOT already direct-sampled (extensions.py docstring).
    count_emissive = jnp.ones(R, dtype=bool)
    use_nee = ext_any and ext.nee and scene.lights is not None
    from ..ops.mxu_intersect import EXCLUDE_PREV_HIT

    prev_u = None  # previous bounce's hit (unique triangle space)
    for bounce in range(max_bounce):
        if ext_any and ext.russian_roulette:
            from .extensions import roulette

            throughput, alive = roulette(throughput, streams, bounce, alive)
        segments = segments + alive.astype(jnp.int32)
        t, u, v, tri = trace_any(
            scene, orig, direction, alive,
            exclude=prev_u if EXCLUDE_PREV_HIT else None,
        )
        prev_u = tri  # dead/missed lanes never consume their value
        (new_orig, new_dir, emissive, albedo, pass_through, missed, normal
         ) = shade_and_scatter(
            scene, orig, direction, t, u, v, tri, streams, bounce
        )

        add_env = alive & missed
        radiance = radiance + jnp.where(
            add_env[:, None], throughput * linalg.env_color(direction), 0.0
        )

        shaded = alive & ~missed & ~pass_through
        add_emis = shaded & count_emissive if use_nee else shaded
        radiance = radiance + jnp.where(add_emis[:, None], throughput * emissive, 0.0)

        take_spec = None
        if ext_any and ext.pbr and scene.ext_mr is not None:
            from .extensions import pbr_scatter

            spec_or_diff, take_spec = pbr_scatter(
                scene, tri, direction, normal, new_dir, streams, bounce
            )
            new_dir = jnp.where(pass_through[:, None], direction, spec_or_diff)

        if use_nee:
            from .extensions import sample_direct_light

            nee_lanes = shaded if take_spec is None else (shaded & ~take_spec)
            radiance = radiance + sample_direct_light(
                scene, new_orig, normal, albedo, throughput, streams, bounce,
                nee_lanes,
            )
            # Next hit's emissive is double-counted only for NEE'd lanes.
            count_emissive = jnp.where(shaded, ~nee_lanes, count_emissive)

        throughput = jnp.where(shaded[:, None], throughput * albedo, throughput)

        stepped = alive & ~missed
        orig = jnp.where(stepped[:, None], new_orig, orig)
        direction = jnp.where(stepped[:, None], new_dir, direction)
        alive = stepped
        # Rays alive after the last bounce contribute nothing — depth
        # exhaustion returns black (src/stage3.zig:189-191).

    return pixel, radiance, segments


def render_wave_rows(
    scene: DeviceScene,
    cam,  # (origin, lower_left, right, up) (3,) f32 vectors
    width: int,
    spp: int,
    max_bounce: int,
    slot_base,  # traced int32: first pixel of this wave
    slot_cap,  # traced int32: rows at pixels >= cap are zeroed (device tile
    #            bound / image bound)
    wave_size: int,
    base_key,
    ext=None,
):
    """Field-major wave contract: returns (rows3 (3, R) radiance in wave
    ray order, segments int32 scalar).  Rays past ``slot_cap`` contribute
    exact zeros, so accumulation is maskless: reshape (3, wp, spp) → sum →
    one dynamic_update_slice."""
    R = wave_size
    slot_lane = slot_base + jnp.asarray(np.arange(R) // spp, jnp.int32)
    mask = slot_lane < slot_cap
    _, radiance, segments = render_wave(
        scene, *cam, width, spp, max_bounce,
        slot_base * spp, R, base_key, pix_base=slot_base, ext=ext,
    )
    rows3 = jnp.where(mask[None, :], radiance.T, 0.0)
    segs = jnp.sum(jnp.where(mask, segments, 0), dtype=jnp.int32)
    return rows3, segs


def _accumulate(fb, rows3, slot_base, spp: int):
    wp = rows3.shape[1] // spp
    sums = rows3.reshape(3, wp, spp).sum(axis=2)
    cur = jax.lax.dynamic_slice(fb, (0, slot_base), (3, wp))
    return jax.lax.dynamic_update_slice(fb, cur + sums, (0, slot_base))


@partial(
    jax.jit,
    static_argnames=(
        "width", "spp", "max_bounce", "wave_size", "num_slots", "num_waves",
        "ext",
    ),
    donate_argnames=("fb",),
)
def render_frame_chunk_emit(
    scene: DeviceScene,
    fb,  # (3, S) field-major framebuffer (pixel-major, padded to waves)
    cam_origin,
    cam_lower_left,
    cam_right,
    cam_up,
    base_key,
    seg_in,  # int32 running segment total (threaded through chunks)
    width: int,
    spp: int,
    max_bounce: int,
    wave_size: int,
    num_slots: int,
    num_waves: int,
    start_wave,
    ext=None,
):
    """``num_waves`` waves in one device call (fori_loop), PLUS the chunk's
    finished pixels gamma-encoded for streaming device→host transfer.

    Each wave owns a disjoint pixel range, so a chunk's pixels are FINAL
    when it returns: they are encoded to u8 here so the caller can
    ``copy_to_host_async`` the slice while later chunks compute.

    Returns (fb, enc, seg_out): ``enc`` is the chunk's pixels as flat u8
    RGB with the RUNNING segment total appended as 4 bytes (little-endian
    int32), so the last chunk's tail gives the frame total without a
    separate scalar fetch.
    """
    wp = wave_size // spp
    cam = (cam_origin, cam_lower_left, cam_right, cam_up)

    def body(wv, carry):
        fb, segs = carry
        slot_base = ((start_wave + wv) * wp).astype(jnp.int32)
        rows3, wave_segs = render_wave_rows(
            scene, cam, width, spp, max_bounce, slot_base,
            jnp.int32(num_slots), wave_size, base_key, ext,
        )
        return _accumulate(fb, rows3, slot_base, spp), segs + wave_segs

    fb, segs = jax.lax.fori_loop(0, num_waves, body, (fb, seg_in))
    s0 = (start_wave * wp).astype(jnp.int32)
    sl = jax.lax.dynamic_slice(fb, (0, s0), (3, num_waves * wp))
    enc = linalg.vec3_to_rgb(sl.T / spp).reshape(-1)
    seg_bytes = jax.lax.bitcast_convert_type(segs, jnp.uint8)
    return fb, jnp.concatenate([enc, seg_bytes]), segs


@partial(
    jax.jit,
    static_argnames=(
        "width", "spp", "max_bounce", "wave_size", "num_slots", "ext",
    ),
    donate_argnames=("fb",),
)
def render_wave_accumulate_rows(
    scene: DeviceScene,
    fb,
    cam_origin,
    cam_lower_left,
    cam_right,
    cam_up,
    base_key,
    wave,
    width: int,
    spp: int,
    max_bounce: int,
    wave_size: int,
    num_slots: int,
    ext=None,
):
    """Single-wave render + accumulate (progressive dumps)."""
    slot_base = (wave * (wave_size // spp)).astype(jnp.int32)
    rows3, segs = render_wave_rows(
        scene, (cam_origin, cam_lower_left, cam_right, cam_up), width, spp,
        max_bounce, slot_base, jnp.int32(num_slots), wave_size, base_key, ext,
    )
    return _accumulate(fb, rows3, slot_base, spp), segs
