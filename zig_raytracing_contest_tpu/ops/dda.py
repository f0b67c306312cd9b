"""Vectorized 3D-DDA (Amanatides–Woo) uniform-grid traversal.

Batched re-design of the reference grid iterator (src/linalg.zig:407-498).
The reference walks one ray at a time with a stateful ``Iterator``; here the
iterator state lives in a struct-of-arrays over a whole ray wave, and
``dda_next`` advances every ray one cell in lock-step.  The
reference's u32-wraparound step encoding (src/linalg.zig:451,492) is
re-expressed with signed int32 steps, which are well-defined; the exit test fires *before* the step so the wraparound is never
semantically observable.

The axis tie-break is parity-critical: the reference picks the stepping axis
via a 3-bit comparison mask and the lookup table ``{2,1,2,1,2,2,0,0}``
(src/linalg.zig:478-484).  The reference's own unit tests
(src/linalg.zig:583-681) pin exact cell sequences including ties — those are
ported verbatim in tests/test_dda.py against this implementation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import linalg

# Axis lookup: index = (t0<t1)<<2 | (t0<t2)<<1 | (t1<t2).  (src/linalg.zig:483)
_AXIS_MAP = jnp.asarray([2, 1, 2, 1, 2, 2, 0, 0], dtype=jnp.int32)

INF = jnp.inf


class GridParams(NamedTuple):
    """Static-ish grid description (small device arrays, replicated).

    Mirrors ``Grid{bbox, resolution, cell_size}`` (src/linalg.zig:407-418).
    ``resolution`` is int32 (3,), ``bbox_min``/``cell_size`` are f32 (3,).
    """

    bbox_min: jnp.ndarray
    bbox_max: jnp.ndarray
    resolution: jnp.ndarray
    cell_size: jnp.ndarray


class DDAState(NamedTuple):
    """Per-ray iterator state, batched: every field has leading shape (R,).

    Mirrors ``Grid.Iterator`` (src/linalg.zig:471-477) with i32 cells/steps.
    """

    cell: jnp.ndarray  # (R, 3) int32
    exit: jnp.ndarray  # (R, 3) int32
    step: jnp.ndarray  # (R, 3) int32
    t_delta: jnp.ndarray  # (R, 3) f32
    t_next_crossing: jnp.ndarray  # (R, 3) f32


def make_grid(bbox_min, bbox_max, resolution):
    """Build GridParams; ``cell_size = size / resolution``.

    (src/linalg.zig:412-418 — Grid.init).
    """
    bbox_min = jnp.asarray(bbox_min, jnp.float32)
    bbox_max = jnp.asarray(bbox_max, jnp.float32)
    resolution = jnp.asarray(resolution, jnp.int32)
    cell_size = (bbox_max - bbox_min) / resolution.astype(jnp.float32)
    return GridParams(bbox_min, bbox_max, resolution, cell_size)


def linearize_cell_idx(grid: GridParams, cell):
    """x-fastest, z-major flat cell index. (src/linalg.zig:429-431)"""
    rx = grid.resolution[0]
    ry = grid.resolution[1]
    return (cell[..., 2] * ry + cell[..., 1]) * rx + cell[..., 0]


def get_cell_idx(grid: GridParams, point):
    """Map a point to a clamped 3D cell index. (src/linalg.zig:424-427)

    The reference truncates to u32 then mins with res-1; a slightly-negative
    local coordinate is UB there — we clamp to [0, res-1] instead.
    """
    pos = (point - grid.bbox_min) / grid.cell_size
    idx = pos.astype(jnp.int32)
    return jnp.clip(idx, 0, grid.resolution - 1)


def dda_setup(grid: GridParams, orig, direction):
    """Enter the grid: slab test + Amanatides–Woo initialization.

    Returns ``(entered, state)`` where ``entered`` is False for rays whose
    slab test misses the scene bbox (those rays' state is garbage and must be
    masked).  Mirrors ``Grid.traceRay`` (src/linalg.zig:443-469):
    entry t clamped to 0 when the origin is inside the bbox (:448).
    """
    hit, t_entry = linalg.ray_bbox_intersection(
        orig, direction, grid.bbox_min, grid.bbox_max
    )
    t_entry = jnp.maximum(0.0, t_entry)

    sign = direction < 0.0
    step = jnp.where(sign, -1, 1).astype(jnp.int32)
    exit_cell = jnp.where(sign, 0, grid.resolution - 1).astype(jnp.int32)
    t_delta = jnp.abs(grid.cell_size / direction)

    hit_local = linalg.ray_at(orig, direction, t_entry) - grid.bbox_min
    cell = jnp.clip(
        (hit_local / grid.cell_size).astype(jnp.int32), 0, grid.resolution - 1
    )
    next_cell = (cell + jnp.where(sign, 0, 1)).astype(jnp.float32)
    t_next = t_entry[..., None] + (next_cell * grid.cell_size - hit_local) / direction

    return hit, DDAState(cell, exit_cell, step, t_delta, t_next)


def dda_next(state: DDAState, active=None):
    """Advance every (active) ray one cell.

    Returns ``(t_crossing, new_state)`` where ``t_crossing`` is the t at which
    the ray leaves its *current* cell, or +inf when the ray is already at the
    grid boundary on the stepping axis (traversal finished) — mirroring
    ``Iterator.next`` (src/linalg.zig:478-496).  Rays with ``active == False``
    keep their state and get t = +inf.
    """
    t = state.t_next_crossing
    t0, t1, t2 = t[..., 0], t[..., 1], t[..., 2]
    k = (
        (t0 < t1).astype(jnp.int32) * 4
        + (t0 < t2).astype(jnp.int32) * 2
        + (t1 < t2).astype(jnp.int32)
    )
    axis = _AXIS_MAP[k]  # (R,)
    onehot = axis[..., None] == jnp.arange(3, dtype=jnp.int32)  # (R, 3) bool

    picked = lambda arr: jnp.sum(jnp.where(onehot, arr, 0), axis=-1)

    at_exit = picked(state.cell) == picked(state.exit)
    t_crossing = jnp.where(at_exit, INF, picked(t))

    do_step = ~at_exit
    if active is not None:
        do_step = do_step & active
        t_crossing = jnp.where(active, t_crossing, INF)

    stepmask = onehot & do_step[..., None]
    new_cell = state.cell + jnp.where(stepmask, state.step, 0)
    new_t = t + jnp.where(stepmask, state.t_delta, 0.0)

    return t_crossing, state._replace(cell=new_cell, t_next_crossing=new_t)
