"""Brute-force NumPy oracle: reference semantics, no acceleration structure.

Used only by tests as the conformance oracle for the wavefront renderer:
primary visibility must match exactly (the grid may never change which
triangle a ray hits), and multi-bounce renders must agree statistically at
high spp (bit-exact RNG parity is impossible; SURVEY.md §7.5).

Mirrors stage3's recursive tracer (src/stage3.zig:152-220) including: nearest
hit with ``t > 0`` filter, back-face culling via MT det, FLT_EPSILON origin
offset, stochastic alpha pass-through that keeps the direction and consumes a
bounce, ``emissive + albedo * recurse(depth-1)``, sky gradient on miss, and
the reference's frac(u)-weight bilinear sampling.

One deliberate divergence (shared by every backend in this repo):
previous-hit exclusion.  The reference's ``t + floatEps`` nudge is a
rounding no-op at t >= 2, so whether a continuation ray phantom-re-hits
its own triangle is compiler/rounding luck even between two builds of the
reference itself; excluding the previous hit (always a phantom for planar
front-face-culled triangles) makes renders deterministic across backends.
See ops.mxu_intersect.EXCLUDE_PREV_HIT.
"""

from __future__ import annotations

import numpy as np

from ..ops.mxu_intersect import EXCLUDE_PREV_HIT
from ..scene.geometry import GeometryArrays
from ..scene.materials import MaterialBank

MT_EPS = 1e-8
FLT_EPSILON = float(np.finfo(np.float32).eps)


def trace_brute(orig, direction, v0, e1, e2, exclude=-1):
    """Nearest t>0 hit over all triangles. Returns (t, u, v, idx); t=inf miss.
    ``exclude``: triangle index the ray may not hit (its previous hit)."""
    orig = orig.astype(np.float32)
    direction = direction.astype(np.float32)
    pvec = np.cross(direction, e2)
    det = np.sum(e1 * pvec, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = 1.0 / det
        tvec = orig - v0
        u = np.sum(tvec * pvec, axis=-1) * inv_det
        qvec = np.cross(tvec, e1)
        v = np.sum(direction * qvec, axis=-1) * inv_det
        t = np.sum(e2 * qvec, axis=-1) * inv_det
    valid = (det >= MT_EPS) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    if exclude >= 0:
        valid = valid & (np.arange(len(det)) != exclude)
    t = np.where(valid, t, np.inf)
    idx = int(np.argmin(t))
    if not np.isfinite(t[idx]):
        return np.inf, 0.0, 0.0, -1
    return float(t[idx]), float(u[idx]), float(v[idx]), idx


def env_color(direction):
    t = 0.5 * (direction[1] + 1.0)
    return (1.0 - t) * np.ones(3, np.float32) + t * np.asarray([0.5, 0.7, 1.0], np.float32)


def sample_texture(data, desc, u, v):
    """Scalar version of ops/texture.py (src/stage3.zig:111-121)."""
    offset, w, h, u_min, u_max, v_min, v_max = (int(x) for x in desc)

    def texel(cf, lo, hi, size):
        ci = int(np.clip(np.floor(cf), -2**31 + 2, 2**31 - 2))
        return int(np.clip(ci, lo, hi)) % size

    ui = np.float32(w) * np.float32(u)
    vi = np.float32(h) * np.float32(v)
    x1 = texel(ui, u_min, u_max, w)
    y1 = texel(vi, v_min, v_max, h)
    x2 = texel(np.floor(ui) + 1, u_min, u_max, w)
    y2 = texel(np.floor(vi) + 1, v_min, v_max, h)

    def pixel(x, y):
        return data[offset + y * w + x]

    fu = abs(u - np.trunc(u))
    fv = abs(v - np.trunc(v))
    r1 = pixel(x1, y1) * (1 - fu) + pixel(x2, y1) * fu
    r2 = pixel(x1, y2) * (1 - fu) + pixel(x2, y2) * fu
    return r1 * (1 - fv) + r2 * fv


class Oracle:
    def __init__(self, geometry: GeometryArrays, materials: MaterialBank):
        self.geometry = geometry
        self.materials = materials
        p = geometry.positions
        self.v0 = p[:, 0]
        self.e1 = p[:, 1] - p[:, 0]
        self.e2 = p[:, 2] - p[:, 0]

    def trace(self, orig, direction, exclude=-1):
        return trace_brute(orig, direction, self.v0, self.e1, self.e2,
                           exclude=exclude)

    def trace_recursive(self, orig, direction, depth,
                        rng: np.random.Generator, prev=-1):
        if depth == 0:
            return np.zeros(3, np.float32)
        if not EXCLUDE_PREV_HIT:
            prev = -1
        t, u, v, idx = self.trace(orig, direction, exclude=prev)
        if not np.isfinite(t):
            return env_color(direction)

        g, m = self.geometry, self.materials
        w0 = 1.0 - u - v
        tc = g.texcoords[idx, 0] * w0 + g.texcoords[idx, 1] * u + g.texcoords[idx, 2] * v
        mat = int(g.material_idx[idx])
        base = sample_texture(m.color_data, m.color_desc[m.mat_base[mat]], tc[0], tc[1])
        albedo = base[:3]
        opacity = base[3]  # reference transparency == base-color alpha channel
        emissive = sample_texture(
            m.color_data, m.color_desc[m.mat_emissive[mat]], tc[0], tc[1]
        )[:3]
        normal = g.normals[idx, 0] * w0 + g.normals[idx, 1] * u + g.normals[idx, 2] * v

        new_orig = orig + direction * (t + FLT_EPSILON)
        if rng.random() > opacity:
            return self.trace_recursive(new_orig, direction, depth - 1, rng,
                                        prev=idx)
        runit = rng.standard_normal(3)
        runit /= np.linalg.norm(runit)
        scattered = normal + runit
        scattered = scattered / np.linalg.norm(scattered)
        return emissive + albedo * self.trace_recursive(
            new_orig, scattered, depth - 1, rng, prev=idx
        )

    def render_pixel(self, camera, px, py, spp, max_bounce, rng):
        """Average spp jittered samples for one pixel (src/stage3.zig:230-242)."""
        acc = np.zeros(3, np.float32)
        for _ in range(spp):
            x = px + rng.random()
            y = py + rng.random()
            d = (
                camera.lower_left_corner
                + camera.right * np.float32(x)
                + camera.up * np.float32(y)
            )
            d = d / np.linalg.norm(d)
            acc += self.trace_recursive(
                camera.origin.astype(np.float32), d.astype(np.float32), max_bounce, rng
            )
        return acc / spp
