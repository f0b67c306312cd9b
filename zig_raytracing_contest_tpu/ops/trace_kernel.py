"""Nearest-hit trace kernel for NVIDIA Hopper: Pallas through Triton.

Same contract as ``mxu_intersect.nearest_hit_mxu`` — (t, u, v, unique
triangle index), a miss for inactive rays, optional previous-hit
``exclude`` — over the same baked bank, with the same tie rule (lowest
bank index wins among equal t).

Layout: one program per block of ``block_rays`` rays.  The block keeps its
running best t / index / u / v in registers and walks the bank in order:
for each group of ``group_tiles`` tiles, a slab test of the group's AABB
against every ray of the block; if no active ray can enter the box nearer
than its running best, the group is skipped, else each of its tiles gets
the same test and a surviving tile is swept in ``chunk``-triangle steps of
(block_rays, chunk) broadcasted FMA.  The work is f32 elementwise FMA,
compares and row minima; no matrix unit is involved, so the result is
exact f32 like the XLA scan (up to FMA contraction and the division's
rounding).

The slab test is written NaN-free: Triton lowers ``jnp.minimum`` to a
NaN-ignoring min, so an axis whose bounds give 0·inf (an axis-parallel ray
whose origin lies on a slab plane) is made unconstraining explicitly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .mxu_intersect import INF, MXUTriangles, _intersect_tile, finish_hits

# Chosen on an H100 (see PERF.md): rays per program, triangles per inner
# step, and the Triton launch parameters.  Small ray blocks keep the box
# culls tight for incoherent bounce rays.
BLOCK_RAYS = 16
CHUNK = 8
NUM_WARPS = 1
NUM_STAGES = 2


def _box_live(box_ref, j, o, inv, best, active):
    """True when some active ray of the block enters box column ``j`` of
    ``box_ref`` (6, N) at a distance below its running best."""
    lo, hi = [], []
    for a in range(3):
        t1 = (box_ref[a, j] - o[a]) * inv[a]
        t2 = (box_ref[3 + a, j] - o[a]) * inv[a]
        nan = (t1 != t1) | (t2 != t2)
        lo.append(jnp.where(nan, -INF, jnp.minimum(t1, t2)))
        hi.append(jnp.where(nan, INF, jnp.maximum(t1, t2)))
    tmin = jnp.maximum(jnp.maximum(lo[0], lo[1]), lo[2])
    tmax = jnp.minimum(jnp.minimum(hi[0], hi[1]), hi[2])
    live = active & (tmin <= tmax) & (tmax > 0.0) & (tmin < best)
    return jnp.max(live.astype(jnp.int32)) > 0


def _trace_kernel(rays_ref, excl_ref, tri_ref, perm_ref, tbox_ref, gbox_ref,
                  t_ref, u_ref, v_ref, i_ref, *, tile, group_tiles,
                  num_groups, chunk, use_exclude):
    o = [rays_ref[a, :] for a in range(3)]
    d = [rays_ref[3 + a, :] for a in range(3)]
    active = rays_ref[6, :] > 0.0
    inv = [1.0 / d[a] for a in range(3)]
    excl = excl_ref[:]
    br = o[0].shape[0]
    col = [x[:, None] for x in (*o, *d)]
    ids = jax.lax.broadcasted_iota(jnp.int32, (br, chunk), 1)

    def sweep_chunk(s, carry):
        best_t, best_i, best_u, best_v = carry
        rows = [tri_ref[r, pl.ds(s, chunk)] for r in range(13)]
        t, u, v, ok = _intersect_tile(*col, rows)
        if use_exclude:
            ok = ok & (perm_ref[pl.ds(s, chunk)][None, :] != excl[:, None])
        t = jnp.where(ok, t, INF)
        cmin = jnp.min(t, axis=1)
        cand = jnp.min(jnp.where(t <= cmin[:, None], ids, chunk), axis=1)
        sel = ids == cand[:, None]
        u_sel = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
        v_sel = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
        better = cmin < best_t
        return (
            jnp.where(better, cmin, best_t),
            jnp.where(better, s + cand, best_i),
            jnp.where(better, u_sel, best_u),
            jnp.where(better, v_sel, best_v),
        )

    def tile_step(j, carry):
        def sweep(carry):
            return jax.lax.fori_loop(
                0, tile // chunk,
                lambda c, cr: sweep_chunk(j * tile + c * chunk, cr), carry,
            )

        live = _box_live(tbox_ref, j, o, inv, carry[0], active)
        return jax.lax.cond(live, sweep, lambda cr: cr, carry)

    def group_step(g, carry):
        def tiles(carry):
            return jax.lax.fori_loop(
                g * group_tiles, (g + 1) * group_tiles, tile_step, carry
            )

        live = _box_live(gbox_ref, g, o, inv, carry[0], active)
        return jax.lax.cond(live, tiles, lambda cr: cr, carry)

    init = (
        jnp.full((br,), INF, jnp.float32),
        jnp.zeros((br,), jnp.int32),
        jnp.zeros((br,), jnp.float32),
        jnp.zeros((br,), jnp.float32),
    )
    best_t, best_i, best_u, best_v = jax.lax.fori_loop(
        0, num_groups, group_step, init
    )
    t_ref[:] = best_t
    i_ref[:] = best_i
    u_ref[:] = best_u
    v_ref[:] = best_v


@functools.partial(
    jax.jit,
    static_argnames=("interpret", "block_rays", "chunk", "num_warps",
                     "num_stages"),
)
def nearest_hit_triton(tris: MXUTriangles, orig, direction, active,
                       exclude=None, *, interpret: bool = False,
                       block_rays: int = BLOCK_RAYS, chunk: int = CHUNK,
                       num_warps: int = NUM_WARPS,
                       num_stages: int = NUM_STAGES):
    """(t, u, v, unique_tri_idx) for (R, 3) rays; R need not be a multiple
    of ``block_rays`` (the wrapper pads with inactive rays).

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    the CPU); otherwise it compiles through Triton for the GPU."""
    R = orig.shape[0]
    tile, group_tiles = tris.tile, tris.group_tiles
    chunk = min(chunk, tile)
    if tile % chunk:
        raise ValueError(f"chunk {chunk} must divide the bank tile {tile}")
    num_groups = tris.group_bbox.shape[1]
    if tris.tile_bbox.shape[1] != num_groups * group_tiles:
        raise ValueError("tile boxes must cover whole groups")
    Rp = -(-max(R, 1) // block_rays) * block_rays
    pad = Rp - R
    act = jnp.pad(active.astype(jnp.float32), (0, pad))
    rays = jnp.concatenate(
        [
            jnp.pad(orig.T.astype(jnp.float32), ((0, 0), (0, pad))),
            jnp.pad(direction.T.astype(jnp.float32), ((0, 0), (0, pad)),
                    constant_values=1.0),
            act[None, :],
            jnp.zeros((1, Rp), jnp.float32),
        ]
    )  # (8, Rp)
    use_exclude = exclude is not None
    excl = (
        jnp.pad(exclude.astype(jnp.int32), (0, pad), constant_values=-1)
        if use_exclude
        else jnp.full((Rp,), -1, jnp.int32)
    )
    kernel = functools.partial(
        _trace_kernel, tile=tile, group_tiles=group_tiles,
        num_groups=num_groups, chunk=chunk, use_exclude=use_exclude,
    )
    ray_block = pl.BlockSpec((block_rays,), lambda i: (i,))
    whole = lambda x: pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)
    t, u, v, idx = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((Rp,), jnp.float32),
            jax.ShapeDtypeStruct((Rp,), jnp.float32),
            jax.ShapeDtypeStruct((Rp,), jnp.float32),
            jax.ShapeDtypeStruct((Rp,), jnp.int32),
        ],
        grid=(Rp // block_rays,),
        in_specs=[
            pl.BlockSpec((8, block_rays), lambda i: (0, i)),
            ray_block,
            whole(tris.tri_data),
            whole(tris.perm),
            whole(tris.tile_bbox),
            whole(tris.group_bbox),
        ],
        out_specs=[ray_block, ray_block, ray_block, ray_block],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="nearest_hit_triton",
    )(rays, excl, tris.tri_data, tris.perm, tris.tile_bbox, tris.group_bbox)
    return finish_hits(tris, active, t[:R], idx[:R], u[:R], v[:R])
