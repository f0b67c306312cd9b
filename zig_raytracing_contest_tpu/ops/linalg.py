"""Batched vector/geometry math for the wavefront renderer.

Batched re-design of the reference math layer (reference: src/linalg.zig).
Everything here is written over *batched* arrays of shape ``(..., 3)`` so a
single call processes a whole ray wave — the reference operates on
one 3-lane SIMD vector at a time (src/linalg.zig:13-222); we operate on
``(R, 3)`` blocks instead, which is the shape XLA tiles onto (8, 128) vregs.

Semantics intentionally pinned to the reference:

* ``cross`` — same component formula as the shuffle-based version
  (src/linalg.zig:172-180).
* ``ray_bbox_intersection`` — branchless-sign slab test returning the *entry*
  t, which is negative when the origin is inside the box
  (src/linalg.zig:324-349).  Comparison order is preserved exactly so NaN
  behavior matches.
* ``moller_trumbore`` — back-face culling (det < 1e-8 ⇒ miss) and the same
  epsilon (src/linalg.zig:696-722).
* ``vec3_to_rgb`` — gamma 2.2 encode; note the reference's ``clamp`` only
  applies the *upper* bound (src/linalg.zig:58-60 computes
  ``min(self, max(lo, hi))``), so we clamp to ``min(x, 0.999999)`` and rely on
  radiance being non-negative, with a lower clip at 0 for NaN/negative safety.
"""

from __future__ import annotations

import jax.numpy as jnp

MT_EPSILON = 1e-8  # reference: src/linalg.zig:701
GAMMA = 2.2  # reference: src/linalg.zig:150


def dot(a, b):
    """Batched dot product over the trailing axis. (src/linalg.zig:190-192)"""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched 3D cross product. (src/linalg.zig:172-180)"""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length(a):
    """Euclidean length over the trailing axis. (src/linalg.zig:119-121)"""
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a):
    """Scale by reciprocal length, exactly like the reference (no epsilon).

    (src/linalg.zig:123-125) — a zero vector yields inf/NaN in both builds.
    """
    return a * (1.0 / length(a))[..., None]


def ray_at(orig, direction, t):
    """Point along a ray: ``orig + dir * t``. (src/linalg.zig:280-287)"""
    return orig + direction * t[..., None]


def ray_bbox_intersection(orig, direction, bbox_min, bbox_max):
    """Branchless-sign slab test. Returns ``(hit, t_entry)``.

    Mirrors reference src/linalg.zig:324-349 including its sequential
    narrowing comparisons (y then z).  ``t_entry`` is negative when the ray
    origin is inside the box (pinned by the reference's own unit test
    "bbox rayIntersection 3", src/linalg.zig:380-392).  ``t_entry`` is
    whatever the math produces even for misses — callers must gate on ``hit``.
    """
    sign = direction < 0.0
    near = (jnp.where(sign, bbox_max, bbox_min) - orig) / direction
    far = (jnp.where(sign, bbox_min, bbox_max) - orig) / direction

    tmin = near[..., 0]
    tmax = far[..., 0]
    miss = (tmin > far[..., 1]) | (tmax < near[..., 1])
    tmin = jnp.maximum(tmin, near[..., 1])
    tmax = jnp.minimum(tmax, far[..., 1])
    miss = miss | (tmin > far[..., 2]) | (tmax < near[..., 2])
    tmin = jnp.maximum(tmin, near[..., 2])
    # (tmax narrowing with far z is dead for the return value; skipped.)
    return ~miss, tmin


def moller_trumbore(orig, direction, v0, e1, e2):
    """Batched Möller–Trumbore with back-face culling.

    Returns ``(valid, t, u, v)``.  ``valid`` is False when ``det < 1e-8``
    (back-facing or parallel — triangles are single-sided in the reference,
    src/linalg.zig:705) or when barycentrics fall outside the triangle.
    ``t`` may be garbage when ``valid`` is False.  Note the reference does
    NOT test ``t > 0`` here — the caller does (src/stage3.zig:174).
    """
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / det
    tvec = orig - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (det >= MT_EPSILON) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return valid, t, u, v


def make_mt_triangles(p0, p1, p2):
    """Precompute Möller–Trumbore form ``(v0, e1, e2)``.

    (src/linalg.zig:688-694 — Triangle.init).
    """
    return p0, p1 - p0, p2 - p0


def vec3_to_rgb(color):
    """Gamma-2.2 encode a float color to u8, reference-exact for valid inputs.

    (src/linalg.zig:150-159) — ``pow(1/2.2)``, upper-clamp at 0.999999
    (the reference's ``clamp`` never applies its lower bound — see module
    docstring), scale by 256, truncate.  We additionally clip below at 0 so
    NaN/negative inputs can't wrap the u8 cast.
    """
    encoded = jnp.power(jnp.maximum(color, 0.0), 1.0 / GAMMA)
    encoded = jnp.clip(encoded, 0.0, 0.999999) * 256.0
    return encoded.astype(jnp.uint8)


def env_color(direction):
    """Sky gradient: lerp(white → (0.5, 0.7, 1.0)) on dir.y.

    (src/stage3.zig:144-150 — getEnvColor).
    """
    t = 0.5 * (direction[..., 1] + 1.0)
    white = jnp.ones(3, dtype=direction.dtype)
    blue = jnp.asarray([0.5, 0.7, 1.0], dtype=direction.dtype)
    return white * (1.0 - t)[..., None] + blue * t[..., None]
