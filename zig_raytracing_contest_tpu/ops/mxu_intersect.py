"""Brute-force nearest hit over a baked triangle bank.

Every triangle (v0, e1, e2) is baked on the host into its *world→barycentric*
affine transform: M = [e1 e2 n]⁻¹ (n = e1 × e2) and c = -M·v0.  For a ray
(o, d):

    o' = M·o + c        d' = M·d
    t  = -o'_w / d'_w   u = o'_u + t·d'_u     v = o'_v + t·d'_v

which equals Möller–Trumbore exactly in real arithmetic (d'_w = dot(d, n)/|n|²
and MT's det = -dot(d, n), so the reference's back-face cull ``det < 1e-8``
(src/linalg.zig:705) becomes ``-d'_w · |n|² < 1e-8`` with |n|² baked per
triangle).  A block of rays against a tile of triangles is then pure
broadcasted FMA on (rays, tile) blocks — exact f32, no per-ray memory
randomness.

Triangles are ordered by a top-down BVH split at bake time, so each tile
of ``tile`` consecutive triangles, and each group of ``group_tiles`` tiles,
is spatially compact; their AABBs let a traversal skip whole tiles.

Two implementations over one baked format:

* ``nearest_hit_xla`` — a ``lax.scan`` over every tile, no culling.  The
  CPU backend's trace and the reference the kernel is tested against.
* ``ops/trace_kernel.nearest_hit_triton`` — the GPU kernel: one program per
  block of rays, a loop over groups and tiles that skips boxes no ray of
  the block can hit nearer than its running best.

Visibility equals the grid path by construction: same hit rule, same
nearest positive t.  Host baking uses float64 inverses, cast to f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

MT_EPSILON = 1e-8
INF = jnp.inf

# Triangles per tile: the unit of the kernel's box cull and of the XLA
# scan step.  A power of two (the kernel's loads are); chosen on an H100
# with the kernel's block sizes (PERF.md).
TRI_TILE = 32
GROUP_TILES = 8  # tiles per second-level cull group

# tri_data row layout: 9 rows of M (row-major), 3 rows of c, 1 row of |n|²,
# padded to 16 rows.
_ROWS = 13
_BANK_ROWS = 16

# Deterministic previous-hit exclusion.  The reference's continuation rays
# re-originate at ray.at(t + floatEps(f32)) (src/stage3.zig:209,216) — an
# ABSOLUTE 1.19e-7 nudge that is a rounding no-op once t >= 2 (ULP(2) =
# 2.4e-7), so whether the new trace phantom-re-hits the SAME triangle at
# t ~ 0 is decided by rounding luck, which differs between backends and
# compilers.  Each phantom re-hit burns a bounce and an RNG draw, fully
# decorrelating two builds in alpha-tested regions.  A same-triangle re-hit
# from a point on the triangle's own plane is ALWAYS phantom: with
# front-face culling (det >= eps) a second legitimate front-face crossing
# of the same plane cannot exist.  So every trace path excludes the ray's
# previous hit triangle, which makes renders deterministic across backends.
EXCLUDE_PREV_HIT = True


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class MXUTriangles:
    """Baked, BVH-ordered triangle bank (padded to whole groups).

    tri_data:  (16, Tp) f32 — transforms in bank order, padded to whole
               group quanta; padding has |n|² = 0, which the det test
               culls unconditionally.
    tile_bbox: (6, num_groups · group_tiles) f32 — [minx..z, maxx..z] per
               tile.  Tiles holding no triangle store the always-miss box
               [min = max = +inf], which the slab test rejects for every
               finite ray.
    perm:      (Tp,) int32 — bank position → original unique triangle id.
    group_bbox: (6, num_groups) f32 — boxes over ``group_tiles``
               consecutive tiles.
    tile / group_tiles: STATIC bake geometry (pytree aux data, so the jit
               cache keys on them).
    """

    tri_data: jnp.ndarray
    tile_bbox: jnp.ndarray
    perm: jnp.ndarray
    group_bbox: jnp.ndarray
    tile: int = TRI_TILE
    group_tiles: int = GROUP_TILES

    def tree_flatten(self):
        return (
            (self.tri_data, self.tile_bbox, self.perm, self.group_bbox),
            (self.tile, self.group_tiles),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def _bvh_order(centroid: np.ndarray, tile: int) -> np.ndarray:
    """BVH-quality triangle order: recursive capacity-aligned spatial splits.

    A top-down BVH whose node boundaries coincide with aligned power-of-two
    ranges of tiles: each subtree of leaf capacity P splits its triangles
    along the widest centroid axis, sending ``min(n, P/2·tile)`` to the
    left child.  Every tile and every aligned group of tiles therefore
    covers a set that an actual axis partition produced, and real tiles
    stay a contiguous prefix (full tiles except the last).
    """
    T = centroid.shape[0]
    num_tiles = -(-max(T, 1) // tile)
    p2 = 1
    while p2 < num_tiles:
        p2 *= 2
    out = np.empty(T, np.int64)
    pos = 0
    stack: list[tuple[np.ndarray, int]] = [(np.arange(T, dtype=np.int64), p2)]
    while stack:
        idx, cap = stack.pop()
        n = idx.shape[0]
        if n == 0:
            continue
        if cap == 1 or n <= tile:
            # n <= tile can only be the rightmost real chunk: every left
            # sibling is filled to exactly min(n, cap/2 · tile).
            out[pos : pos + n] = idx
            pos += n
            continue
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        n_left = min(n, (cap // 2) * tile)
        part = np.argpartition(c[:, axis], n_left - 1)
        stack.append((idx[part[n_left:]], cap // 2))  # right (popped later)
        stack.append((idx[part[:n_left]], cap // 2))  # left (popped first)
    return out


def bake_triangles(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    tile: int = TRI_TILE,
    group_tiles: int = GROUP_TILES,
) -> MXUTriangles:
    """Host-side bake: MT arrays → BVH-ordered transform bank + boxes."""
    if tile <= 0 or tile & (tile - 1):
        raise ValueError(f"tile {tile} must be a power of two")
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    T = v0.shape[0]

    centroid = v0 + (e1 + e2) / 3.0
    order = _bvh_order(centroid, tile)
    v0, e1, e2 = v0[order], e1[order], e2[order]

    n = np.cross(e1, e2)
    n_sq = np.sum(n * n, axis=-1)
    # M rows are the reciprocal basis of [e1 e2 n]; det3 = dot(e1, e2×n) = |n|².
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det3 = 1.0 / n_sq
        r_u = np.cross(e2, n) * inv_det3[:, None]
        r_v = np.cross(n, e1) * inv_det3[:, None]
        r_w = n * inv_det3[:, None]
    M = np.stack([r_u, r_v, r_w], axis=1)  # (T, 3, 3)
    c = -np.einsum("tak,tk->ta", M, v0)  # (T, 3)

    quantum = tile * group_tiles
    Tp = -(-max(T, 1) // quantum) * quantum
    tri_data = np.zeros((_BANK_ROWS, Tp), np.float32)
    tri_data[0:9, :T] = M.reshape(T, 9).T.astype(np.float32)
    tri_data[9:12, :T] = c.T.astype(np.float32)
    tri_data[12, :T] = n_sq.astype(np.float32)

    # Per-tile AABBs over the three vertices of each member triangle;
    # tiles without triangles keep the always-miss box.
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (T, 3, 3)
    num_tiles = Tp // tile
    num_groups = num_tiles // group_tiles
    tile_bbox = np.full((6, num_tiles), np.inf, np.float32)
    for ti in range(-(-T // tile)):
        flat = verts[ti * tile : min((ti + 1) * tile, T)].reshape(-1, 3)
        tile_bbox[0:3, ti] = flat.min(axis=0)
        tile_bbox[3:6, ti] = flat.max(axis=0)

    g = tile_bbox.reshape(6, num_groups, group_tiles)
    empty = np.isinf(g[0])  # (num_groups, group_tiles)
    group_bbox = np.full((6, num_groups), np.inf, np.float32)
    with np.errstate(invalid="ignore"):
        group_bbox[0:3] = np.where(empty, np.inf, g[0:3]).min(axis=2)
        group_bbox[3:6] = np.where(empty, -np.inf, g[3:6]).max(axis=2)
    group_bbox[:, empty.all(axis=1)] = np.inf

    perm = np.zeros(Tp, np.int32)
    perm[:T] = order.astype(np.int32)
    return MXUTriangles(
        tri_data=jnp.asarray(tri_data),
        tile_bbox=jnp.asarray(tile_bbox),
        perm=jnp.asarray(perm),
        group_bbox=jnp.asarray(group_bbox),
        tile=tile,
        group_tiles=group_tiles,
    )


def _intersect_tile(ox, oy, oz, dx, dy, dz, rows):
    """Core math for one (rays × tile) block.  Inputs are (Rb, 1) ray
    component columns and (13, Kt) transform rows; returns (t, u, v, ok)
    as (Rb, Kt) tiles.  Shared by the XLA scan and the GPU kernel."""
    m = lambda r: rows[r][None, :]
    ou = ox * m(0) + oy * m(1) + oz * m(2) + m(9)
    ov = ox * m(3) + oy * m(4) + oz * m(5) + m(10)
    ow = ox * m(6) + oy * m(7) + oz * m(8) + m(11)
    du = dx * m(0) + dy * m(1) + dz * m(2)
    dv = dx * m(3) + dy * m(4) + dz * m(5)
    dw = dx * m(6) + dy * m(7) + dz * m(8)
    t = -ow / dw
    u = ou + t * du
    v = ov + t * dv
    det = -dw * m(12)
    # (u <= 1 is implied: with v >= 0, any u > 1 makes u+v round to > 1.)
    ok = (
        (det >= MT_EPSILON)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
    )
    return t, u, v, ok


def nearest_hit_xla(tris: MXUTriangles, orig, direction, active,
                    exclude=None):
    """Portable tile scan.  Returns (t, idx_bank, u, v).

    ``exclude``: optional (R,) int32 UNIQUE-space triangle index each ray
    may not hit again (EXCLUDE_PREV_HIT — the previous hit), compared via
    the per-tile slice of ``tris.perm``.  Ties resolve to the lowest bank
    index: the first minimum within a tile, and a later tile replaces the
    running best only when strictly nearer."""
    tile = tris.tile
    R = orig.shape[0]
    Tp = tris.tri_data.shape[1]
    num_tiles = Tp // tile
    ox, oy, oz = (orig[:, i : i + 1] for i in range(3))
    dx, dy, dz = (direction[:, i : i + 1] for i in range(3))

    def body(carry, tile_idx):
        best_t, best_i, best_u, best_v = carry
        s = tile_idx * tile
        rows = jax.lax.dynamic_slice(tris.tri_data, (0, s), (_ROWS, tile))
        t, u, v, ok = _intersect_tile(ox, oy, oz, dx, dy, dz, rows)
        if exclude is not None:
            pm = jax.lax.dynamic_slice(tris.perm, (s,), (tile,))
            ok = ok & (pm[None, :] != exclude[:, None])
        t = jnp.where(ok, t, INF)
        tile_min = jnp.min(t, axis=1)
        ids = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        cand = jnp.min(jnp.where(t <= tile_min[:, None], ids, Tp), axis=1)
        sel = ids == cand[:, None]
        u_sel = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
        v_sel = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
        better = tile_min < best_t
        best_t = jnp.where(better, tile_min, best_t)
        best_i = jnp.where(better, s + cand, best_i)
        best_u = jnp.where(better, u_sel, best_u)
        best_v = jnp.where(better, v_sel, best_v)
        return (best_t, best_i, best_u, best_v), None

    init = (
        jnp.full((R,), INF, jnp.float32),
        jnp.zeros((R,), jnp.int32),
        jnp.zeros((R,), jnp.float32),
        jnp.zeros((R,), jnp.float32),
    )
    (best_t, best_i, best_u, best_v), _ = jax.lax.scan(
        body, init, jnp.arange(num_tiles, dtype=jnp.int32)
    )
    best_t = jnp.where(active, best_t, INF)
    return best_t, best_i, best_u, best_v


def finish_hits(tris: MXUTriangles, active, t, idx_bank, u, v):
    """Shared trace contract: (t, u, v, unique_tri_idx), a miss (t = inf,
    u = v = 0, idx 0) for inactive rays and for rays that hit nothing."""
    t = jnp.where(active, t, INF)
    hit = jnp.isfinite(t)
    u = jnp.where(hit, u, 0.0)
    v = jnp.where(hit, v, 0.0)
    idx = tris.perm[jnp.clip(idx_bank, 0, tris.perm.shape[0] - 1)]
    return t, u, v, jnp.where(hit, idx, 0)


def nearest_hit_mxu(tris: MXUTriangles, orig, direction, active,
                    exclude=None):
    """Nearest hit through the XLA tile scan.  Returns (t, u, v,
    unique_tri_idx); inactive rays report t = inf.  ``exclude``: optional
    (R,) int32 unique-space previous-hit index (see nearest_hit_xla)."""
    t, idx_b, u, v = nearest_hit_xla(tris, orig, direction, active,
                                     exclude=exclude)
    return finish_hits(tris, active, t, idx_b, u, v)
