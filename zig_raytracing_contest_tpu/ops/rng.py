"""Stateless counter-based RNG, pure vector ops — no threefry, no gathers.

The reference seeds one sequential PRNG per OS thread with the thread index
(src/stage3.zig:225), so its output depends on thread count.  The
replacement here derives every random draw as a pure function of
(seed, global ray id, stream tag): deterministic regardless of wave size,
device count, or sharding, and embarrassingly vectorizable.

A two-stage integer mix (SplitMix/lowbias-style finalizers), ~10 int ops
per 32-bit draw, in place of vmapped ``jax.random.fold_in`` chains
(threefry).  Bit-exact parity with the
reference is impossible by construction (SURVEY.md §7.5); acceptance is
statistical, so hash quality (avalanche) is what matters, not crypto.
"""

from __future__ import annotations

import jax.numpy as jnp

_TWO_PI = 6.283185307179586


def _mix(x):
    """lowbias32-style avalanche finalizer on uint32."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def ray_streams(seed, global_ray_ids):
    """Per-ray stream state from (seed, global ray id).  (R,) uint32."""
    gid = global_ray_ids.astype(jnp.uint32)
    s = jnp.asarray(seed, jnp.uint32)
    return _mix(gid ^ (s * jnp.uint32(0x9E3779B9)) ^ jnp.uint32(0x85EBCA6B))


def _bits(streams, tag, word: int):
    """One 32-bit word of the (stream, tag) draw sequence.

    ``tag`` may be a Python int or a traced int (e.g. a lax.scan bounce
    index) — the stream constants are mixed with uint32 wraparound either
    way.
    """
    t = (jnp.asarray(tag).astype(jnp.uint32) * 2 + 1)
    w = jnp.uint32((word * 0x9E3779B9 + 0x6A09E667) & 0xFFFFFFFF)
    return _mix(streams ^ (t * jnp.uint32(0xB5297A4D)) ^ w)


def _u01(bits):
    """uint32 → float32 in (0, 1): 24-bit mantissa, never exactly 0.

    Routed through int32 (exact: the 24-bit value is int32-safe); the
    native C++ tracer mirrors this definition.
    """
    return ((bits >> 8).astype(jnp.int32).astype(jnp.float32) + 0.5) * jnp.float32(
        1.0 / (1 << 24)
    )


def uniform(streams, tag: int):
    """(R,) uniforms in (0, 1) for this stream/tag."""
    return _u01(_bits(streams, tag, 0))


def uniform2_soa(streams, tag):
    """Two (R,) uniforms — pixel jitter (src/stage3.zig:238)."""
    return _u01(_bits(streams, tag, 0)), _u01(_bits(streams, tag, 1))


def uniform2(streams, tag):
    """(R, 2) variant of uniform2_soa."""
    a, b = uniform2_soa(streams, tag)
    return jnp.stack([a, b], -1)


def normal3_soa(streams, tag):
    """Three (R,) standard normals via Box–Muller — Gaussian sphere sampling
    feed (src/linalg.zig:140-148).  Uses 4 uniform words; the 4th normal is
    discarded.  SoA output keeps everything in dense (R,) layouts."""
    u1 = _u01(_bits(streams, tag, 0))
    u2 = _u01(_bits(streams, tag, 1))
    u3 = _u01(_bits(streams, tag, 2))
    u4 = _u01(_bits(streams, tag, 3))
    r1 = jnp.sqrt(-2.0 * jnp.log(u1))
    r2 = jnp.sqrt(-2.0 * jnp.log(u3))
    a1 = _TWO_PI * u2
    a2 = _TWO_PI * u4
    return r1 * jnp.cos(a1), r1 * jnp.sin(a1), r2 * jnp.cos(a2)


def normal3(streams, tag):
    """(R, 3) variant of normal3_soa (oracle comparisons / tests)."""
    x, y, z = normal3_soa(streams, tag)
    return jnp.stack([x, y, z], -1)
