"""The Triton trace kernel (ops/trace_kernel.py) against the XLA tile scan.

The kernel must return what ``nearest_hit_mxu`` returns — same winner,
same t/u/v, a miss for inactive rays, the same previous-hit exclusion —
for any ray count, on banks of one tile, one group, or many groups.

Here the kernel runs in the Pallas interpreter, which executes the same
jaxpr on the CPU, so results are bit-identical.  The ``gpu``-marked twins
compile it through Triton and hold it to the tolerance f32 FMA contraction
and the division's rounding allow; they skip without a card and are run
on one by ``chip_smoke.py`` (phase 2) or by
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_trace_kernel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_raytracing_contest_tpu.ops.mxu_intersect import (
    GROUP_TILES,
    TRI_TILE,
    bake_triangles,
    nearest_hit_mxu,
)
from zig_raytracing_contest_tpu.ops.trace_kernel import (
    BLOCK_RAYS,
    _box_live,
    nearest_hit_triton,
)

# Bank sizes: inside one tile; several tiles of one group; many groups.
SCENES = {
    "one_tile": TRI_TILE // 2,
    "one_group": 3 * TRI_TILE,
    "multi_group": 5 * TRI_TILE * GROUP_TILES + 7,
}
# Ray sets: a count that is not a multiple of the block, all active; and
# a block multiple with inactive lanes and axis-parallel directions.
RAYS = {
    "ragged": (3 * BLOCK_RAYS + 17, 0.0),
    "inactive": (4 * BLOCK_RAYS, 0.3),
}
CASES = [
    (scene, rays, exclude)
    for scene in SCENES
    for rays in RAYS
    for exclude in (False, True)
]


def _case_id(case):
    scene, rays, exclude = case
    return f"{scene}-{rays}-{'exclude' if exclude else 'plain'}"


def make_case(scene: str, rays: str, exclude: bool, seed: int = 0):
    """(tris, orig, dirs, active, exclude) for one case: a random triangle
    soup in front of rays aimed into it from z = 8."""
    rng = np.random.default_rng(seed)
    T = SCENES[scene]
    v0 = rng.uniform(-3, 3, (T, 3))
    e1 = rng.normal(0, 0.6, (T, 3))
    e2 = rng.normal(0, 0.6, (T, 3))
    tris = bake_triangles(v0, e1, e2)
    R, dead = RAYS[rays]
    o = rng.uniform(-1, 1, (R, 3))
    o[:, 2] = 8.0
    d = rng.normal(0, 0.35, (R, 3))
    d[:, 2] = -1.0
    if dead:
        d[: R // 8, 0] = 0.0  # axis-parallel: 0 * inf in the slab test
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.uniform(size=R) >= dead
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    act = jnp.asarray(active)
    excl = None
    if exclude:
        # Exclude each ray's own nearest triangle on even lanes (the answer
        # must become the next one behind it) and a random one elsewhere.
        _, _, _, first = nearest_hit_mxu(tris, o, d, act)
        rand = rng.integers(0, T, R)
        excl = jnp.asarray(
            np.where(np.arange(R) % 2 == 0, np.asarray(first), rand),
            jnp.int32,
        )
    return tris, o, d, act, excl


def compare_hits(ref, got, exact: bool, abs_tol=0.0, self_band: float = 0.0):
    """Problems between two (t, u, v, idx) results, as strings.

    exact: bit-identical.  Otherwise the winner must agree on >= 99.9% of
    rays, |dt| <= 1e-5 t + abs_tol (a scalar or one value per ray) where it
    agrees, and where it differs both t must lie that close to each other
    (a tie).  Rays where either side hits nearer than ``self_band`` are
    left out: a continuation ray starting on a surface can hit a coplanar
    back-to-back face at t ~ 0 or not, as the last bit of its origin
    decides, and two backends round that bit differently."""
    t0, u0, v0, i0 = (np.asarray(x) for x in ref)
    t1, u1, v1, i1 = (np.asarray(x) for x in got)
    if exact:
        return [
            f"{name} differs on {int((a != b).sum())} rays"
            for name, a, b in (("t", t0, t1), ("u", u0, u1), ("v", v0, v1),
                               ("idx", i0, i1))
            if not np.array_equal(a, b)
        ]
    problems = []
    keep = ~(np.minimum(t0, t1) < self_band)
    t0, t1, i0, i1 = t0[keep], t1[keep], i0[keep], i1[keep]
    abs_tol = np.broadcast_to(np.asarray(abs_tol, np.float64), keep.shape)
    abs_tol = abs_tol[keep]
    if not np.isfinite(abs_tol).all():
        problems.append("the |dt| tolerance is not finite")
    fin0, fin1 = np.isfinite(t0), np.isfinite(t1)
    same = (i0 == i1) & (fin0 == fin1)
    if same.size and same.mean() < 0.999:
        problems.append(f"winner agrees on only {same.mean():.5%} of rays")
    both = same & fin0
    far = np.maximum(np.where(fin0, t0, 0.0), np.where(fin1, t1, 0.0))
    scale = 1e-5 * far + abs_tol
    with np.errstate(invalid="ignore"):  # inf - inf on misses, masked
        dt = np.abs(np.where(fin0 & fin1, t0 - t1, 0.0))
    if (dt[both] > scale[both]).any():
        worst = int(np.argmax(np.where(both, dt - scale, -np.inf)))
        problems.append(f"{int((dt[both] > scale[both]).sum())} agreeing "
                        f"rays with |dt| > 1e-5 t + {abs_tol[worst]:g} "
                        f"(worst: t {t0[worst]!r} vs {t1[worst]!r})")
    tie = ~same & fin0 & fin1 & (dt <= scale)
    other = ~same & ~tie
    if other.any():
        problems.append(
            f"{int(other.sum())} rays differ without a tie (first t pairs: "
            f"{list(zip(t0[other][:3].tolist(), t1[other][:3].tolist()))})"
        )
    return problems


def check_case(case, interpret: bool, **kernel_args):
    """Run one case through the kernel and the XLA scan on the default
    device; returns the list of problems (empty = pass)."""
    tris, o, d, act, excl = make_case(*case)
    ref = nearest_hit_mxu(tris, o, d, act, exclude=excl)
    got = nearest_hit_triton(tris, o, d, act, excl, interpret=interpret,
                             **kernel_args)
    inactive_hits = int(np.isfinite(np.asarray(got[0]))[~np.asarray(act)].sum())
    problems = compare_hits(ref, got, exact=interpret)
    if inactive_hits:
        problems.append(f"{inactive_hits} inactive rays report a hit")
    return problems


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_matches_scan_interpret(case):
    assert check_case(case, interpret=True) == []


@pytest.mark.parametrize(
    "block_rays,chunk", [(32, 16), (128, 64), (16, TRI_TILE)]
)
def test_kernel_block_shapes_interpret(block_rays, chunk):
    case = ("multi_group", "inactive", True)
    assert check_case(case, True, block_rays=block_rays, chunk=chunk) == []


def test_exclusion_reveals_the_hit_behind():
    """Excluding a ray's nearest triangle returns a strictly farther hit."""
    tris, o, d, act, _ = make_case("one_group", "ragged", False)
    t0, _, _, i0 = nearest_hit_triton(tris, o, d, act, interpret=True)
    t1, _, _, i1 = nearest_hit_triton(tris, o, d, act, i0, interpret=True)
    hit1 = np.isfinite(np.asarray(t1))
    assert hit1.any()
    assert not (np.asarray(i1)[hit1] == np.asarray(i0)[hit1]).any()
    assert (np.asarray(t1)[hit1] >= np.asarray(t0)[hit1]).all()


def test_box_test_is_nan_free():
    """An axis-parallel ray whose origin lies on a box face (0 * inf in the
    slab test) must not cull a box it passes through, and an always-miss
    box (min = max = +inf) is culled for every ray."""
    box = jnp.asarray([[0.0, -1.0], [-1.0, np.inf], [-1.0, np.inf],
                       [1.0, -1.0], [1.0, np.inf], [1.0, np.inf]],
                      jnp.float32)  # column 0 real, column 1 always-miss
    o = [jnp.asarray([0.0]), jnp.asarray([1.0]), jnp.asarray([5.0])]
    d = [jnp.asarray([0.0]), jnp.asarray([0.0]), jnp.asarray([-1.0])]
    inv = [1.0 / x for x in d]
    best = jnp.asarray([np.inf])
    act = jnp.asarray([True])
    assert bool(_box_live(box, 0, o, inv, best, act))
    assert not bool(_box_live(box, 1, o, inv, best, act))
    assert not bool(_box_live(box, 0, o, inv, jnp.asarray([3.0]), act))
    assert not bool(_box_live(box, 0, o, inv, best, jnp.asarray([False])))


def test_bake_pads_tiles_to_whole_groups():
    T = SCENES["multi_group"]
    tris = bake_triangles(
        np.random.default_rng(1).uniform(-1, 1, (T, 3)),
        np.full((T, 3), 0.1),
        np.tile([0.0, 0.1, 0.0], (T, 1)),
    )
    num_tiles = tris.tile_bbox.shape[1]
    assert num_tiles == tris.group_bbox.shape[1] * tris.group_tiles
    assert tris.tri_data.shape[1] == num_tiles * tris.tile
    real = -(-SCENES["multi_group"] // tris.tile)
    box = np.asarray(tris.tile_bbox)
    assert np.isfinite(box[:, :real]).all()
    assert np.isinf(box[:, real:]).all() and (box[:, real:] > 0).all()
    gb = np.asarray(tris.group_bbox)
    for g in range(gb.shape[1]):
        tiles = box[:, g * tris.group_tiles : (g + 1) * tris.group_tiles]
        tiles = tiles[:, np.isfinite(tiles[0])]
        if tiles.size:
            np.testing.assert_array_equal(gb[0:3, g], tiles[0:3].min(axis=1))
            np.testing.assert_array_equal(gb[3:6, g], tiles[3:6].max(axis=1))


def test_wrapper_rejects_chunk_not_dividing_tile():
    tris, o, d, act, _ = make_case("one_tile", "ragged", False)
    with pytest.raises(ValueError, match="chunk"):
        nearest_hit_triton(tris, o, d, act, interpret=True,
                           chunk=TRI_TILE // 2 + 1)


@pytest.fixture
def gpu():
    """Skips unless JAX's default device is a GPU (decided at run time,
    never at import, so every test worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run on the card (chip_smoke.py phase 2)")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_matches_scan_compiled(gpu, case):
    assert check_case(case, interpret=False) == []
