"""Statistical quality of the counter-hash RNG (ops/rng.py).

The reference uses one sequential PRNG per OS thread (src/stage3.zig:225);
our replacement derives every draw from (seed, ray id, tag).  A subtle
stream correlation would bias every render silently, so uniformity and
independence are pinned directly, not just through image statistics.
All bounds are deterministic (fixed seeds) with wide safety margins.
"""

import jax.numpy as jnp
import numpy as np

from zig_raytracing_contest_tpu.ops import rng

N = 1 << 20


def _uniforms(seed=1, tag=1, n=N):
    streams = rng.ray_streams(jnp.uint32(seed), jnp.arange(n, dtype=jnp.int32))
    return np.asarray(rng.uniform(streams, tag))


def test_uniform_chi_square():
    """256-bin chi-square over 2^20 draws.  dof=255: mean 255, std ~22.6;
    1000 is a > 30-sigma bound — fails only on real structure."""
    u = _uniforms()
    counts, _ = np.histogram(u, bins=256, range=(0.0, 1.0))
    expected = N / 256
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 1000, f"chi2={chi2}"
    assert 0.0 < u.min() and u.max() < 1.0  # open interval (log() safety)


def test_bit_balance():
    """Every one of the 32 output bits is ~50% set (binomial 3e-3 bound)."""
    streams = rng.ray_streams(jnp.uint32(9), jnp.arange(N, dtype=jnp.int32))
    bits = np.asarray(rng._bits(streams, 5, 0)).astype(np.uint64)
    for b in range(32):
        frac = float(((bits >> b) & 1).mean())
        assert abs(frac - 0.5) < 3e-3, f"bit {b}: {frac}"


def test_cross_tag_and_cross_word_independence():
    """Draws from different tags/words of the same streams decorrelate:
    |r| for independent 2^20-samples is ~1e-3; 0.01 is a 10-sigma bound."""
    streams = rng.ray_streams(jnp.uint32(4), jnp.arange(N, dtype=jnp.int32))
    u_tags = [np.asarray(rng.uniform(streams, tag)) for tag in range(6)]
    for i in range(len(u_tags)):
        for j in range(i + 1, len(u_tags)):
            r = np.corrcoef(u_tags[i], u_tags[j])[0, 1]
            assert abs(r) < 0.01, f"tags {i},{j}: r={r}"
    w0 = np.asarray(rng._u01(rng._bits(streams, 1, 0)))
    w1 = np.asarray(rng._u01(rng._bits(streams, 1, 1)))
    assert abs(np.corrcoef(w0, w1)[0, 1]) < 0.01


def test_adjacent_ray_independence():
    """Neighboring ray ids (the pathological counter case) decorrelate,
    including lag-1..4 serial correlation within one tag."""
    u = _uniforms(seed=2, tag=3)
    for lag in (1, 2, 3, 4):
        r = np.corrcoef(u[:-lag], u[lag:])[0, 1]
        assert abs(r) < 0.01, f"lag {lag}: r={r}"


def test_seed_and_stream_sensitivity():
    """Different seeds give unrelated streams; stream state itself avalanches
    (one-bit ray-id flips change ~half the output bits)."""
    a = _uniforms(seed=11, n=1 << 16)
    b = _uniforms(seed=12, n=1 << 16)
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.02
    ids = jnp.arange(1 << 16, dtype=jnp.int32)
    s0 = np.asarray(rng.ray_streams(jnp.uint32(0), ids))
    s1 = np.asarray(rng.ray_streams(jnp.uint32(0), ids ^ 1))
    flipped = np.unpackbits((s0 ^ s1).view(np.uint8)).mean() * 32
    assert 12 < flipped < 20, f"avalanche: {flipped} bits flipped on average"


def test_normal3_moments():
    """Box–Muller normals: mean ~0, var ~1, cross-component independence."""
    streams = rng.ray_streams(jnp.uint32(6), jnp.arange(N, dtype=jnp.int32))
    g = np.asarray(rng.normal3(streams, 2))
    assert np.all(np.abs(g.mean(axis=0)) < 0.01)
    assert np.all(np.abs(g.var(axis=0) - 1.0) < 0.02)
    c = np.corrcoef(g.T)
    off = c[~np.eye(3, dtype=bool)]
    assert np.all(np.abs(off) < 0.01)
