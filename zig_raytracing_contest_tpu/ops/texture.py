"""Batched bilinear texture sampling from flat texture banks.

Reference semantics (src/stage3.zig:82-123) reproduced exactly, including its
quirks, per SURVEY.md §7 hard-part (b):

* texel coords: ``floor(w * u)`` / ``floor(h * v)`` as int32;
* clamp to per-texture [u_min, u_max] (full int32 range means repeat), then
  floored-mod by the texture size (``@mod`` in Zig == ``jnp.mod`` for a
  positive divisor);
* bilinear weights are ``frac(u) = |u - trunc(u)|`` of the RAW uv coordinate
  (src/stage3.zig:94-96,118-120) — NOT of the scaled texel coordinate.  This
  is the reference's defining quirk and golden renders depend on it.

Each ray supplies a descriptor row [offset, w, h, u_min, u_max, v_min, v_max]
gathered from the material table; sampling is two gathers + VPU math.
"""

from __future__ import annotations

import jax.numpy as jnp

_I32_SAFE_LO = -(2**31) + 2
_I32_SAFE_HI = 2**31 - 2


def _frac(v):
    return jnp.abs(v - jnp.trunc(v))


def _texel_pair(u, wf, lo_f, hi_f, is_repeat):
    """Texel indices (x1, x2) for one axis, all-float math.

    No integer divide or mod: the reference semantics
    (src/stage3.zig:112-117):

        x1 = mod(clamp(floor(w·u), lo, hi), w)
        x2 = mod(clamp(floor(w·u)+1, lo, hi), w)

    Repeat mode (lo/hi at the int32 sentinels, clamp = identity) satisfies
    ``floor(w·u) mod w == floor(w · (u - floor(u)))`` for integer w, and
    ``x2 = (x1+1) mod w == x1+1 - w·[x1+1 ≥ w]`` — both pure float ops,
    exact wherever the reference's own f32 ``floor(w·u)`` is exact.  Clamp
    mode clamps in float (bounds ≤ 2^24, exactly representable) and the mod
    is then the identity.
    """
    # repeat path
    fu = u - jnp.floor(u)  # floored frac in [0, 1)
    rx1 = jnp.minimum(jnp.floor(wf * fu), wf - 1.0)  # guard w*frac rounding to w
    rx2 = rx1 + 1.0
    rx2 = jnp.where(rx2 >= wf, rx2 - wf, rx2)
    # clamp path
    cu = jnp.floor(wf * jnp.clip(u, -float(_I32_SAFE_HI), float(_I32_SAFE_HI)))
    cx1 = jnp.clip(cu, lo_f, hi_f)
    cx2 = jnp.clip(cu + 1.0, lo_f, hi_f)
    x1 = jnp.where(is_repeat, rx1, cx1)
    x2 = jnp.where(is_repeat, rx2, cx2)
    return x1.astype(jnp.int32), x2.astype(jnp.int32)


def sample_texture(data, desc_rows, u, v):
    """Sample a bank of textures bilinearly.

    data: (P, C) f32 or (P,) f32 flat texel bank.
    desc_rows: (R, 7) descriptor per ray — int32, or f32-encoded (the fat
    shade_table stores them as floats; values are exact up to 2^24 and the
    repeat sentinels are ±2^30).
    u, v: (R,) f32 texture coordinates.
    Returns (R, C) or (R,) sampled values.
    """
    desc_f = desc_rows.astype(jnp.float32)
    offset = desc_rows[:, 0].astype(jnp.int32)
    w = desc_rows[:, 1].astype(jnp.int32)
    wf = desc_f[:, 1]
    hf = desc_f[:, 2]
    # Repeat mode is encoded as sentinel bounds (negative lower bound);
    # clamp mode always has a 0 lower bound (src/stage1.zig:381-409).
    u_repeat = desc_f[:, 3] < 0.0
    v_repeat = desc_f[:, 5] < 0.0

    x1, x2 = _texel_pair(u, wf, desc_f[:, 3], desc_f[:, 4], u_repeat)
    y1, y2 = _texel_pair(v, hf, desc_f[:, 5], desc_f[:, 6], v_repeat)

    def pixel(x, y):
        return data[offset + y * w + x]

    fu = _frac(u)
    fv = _frac(v)
    if data.ndim == 2:
        fu = fu[:, None]
        fv = fv[:, None]
    r1 = pixel(x1, y1) * (1.0 - fu) + pixel(x2, y1) * fu
    r2 = pixel(x1, y2) * (1.0 - fu) + pixel(x2, y2) * fu
    return r1 * (1.0 - fv) + r2 * fv
