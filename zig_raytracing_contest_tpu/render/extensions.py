"""Opt-in rendering extensions: NEE, Russian roulette, metallic-roughness.

These are the BASELINE.json "north star" extras (SURVEY.md §7.7) — the
reference itself has NONE of them (plain recursive path tracing,
src/stage3.zig:188-220; metallic/roughness ignored, src/stage1.zig:471-483)
— so they are strictly additive and OFF by default (config keys ``nee``,
``russian_roulette``, ``pbr``).  They run in render_wave's XLA shading
loop, with whichever trace the platform uses.

Estimator notes: the reference's scatter ``normalize(normal + unit_vector)``
IS cosine-weighted hemisphere sampling, so the implicit BRDF is Lambertian
``albedo/π`` and the plain estimator weight per bounce is exactly
``albedo``.  NEE samples emissive triangle area directly (area pdf
1/total_area) and the indirect ray then skips emissive on its next hit to
avoid double counting; both estimators target the same integral, so images
converge to the plain path tracer's (pinned statistically in
tests/test_extensions.py).  Russian roulette keeps paths unbiased by
dividing surviving throughput by the survival probability.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import linalg, rng
from ..ops.texture import sample_texture

# RNG tag bases — far above the core tags (0 = jitter, 2b+1 = alpha,
# 2b+2 = scatter gaussian) for ANY realistic max_bounce.
TAG_RR = 1 << 20
TAG_NEE = 1 << 21
TAG_PBR = 1 << 22


class ExtFlags(NamedTuple):
    """Static (hashable) extension switches, derived from Config."""

    nee: bool = False
    russian_roulette: bool = False
    pbr: bool = False

    @property
    def any(self) -> bool:
        return self.nee or self.russian_roulette or self.pbr


class LightSet(NamedTuple):
    """Emissive-triangle sampling table (device arrays).

    tri:    (L,) int32 unique-triangle ids (for emissive texture + uv)
    v0/e1/e2: (L, 3) f32 positions (v0 + e1*b1 + e2*b2 parameterization)
    normal: (L, 3) f32 unit geometric normal (the side MT can hit)
    cdf:    (L,) f32 area-weighted cumulative distribution (ends at 1)
    total_area: (1,) f32
    """

    tri: jnp.ndarray
    v0: jnp.ndarray
    e1: jnp.ndarray
    e2: jnp.ndarray
    normal: jnp.ndarray
    cdf: jnp.ndarray
    total_area: jnp.ndarray


def build_light_set(geometry, materials) -> LightSet | None:
    """Collect triangles whose material emits (any emissive texel > 0)."""
    emis_desc = materials.color_desc[materials.mat_emissive]  # (M, 7)
    mat_emits = np.zeros(len(emis_desc), bool)
    for m, d in enumerate(emis_desc):
        texels = materials.color_data[d[0] : d[0] + d[1] * d[2], :3]
        mat_emits[m] = bool((texels > 0).any())
    tri_ids = np.nonzero(mat_emits[geometry.material_idx])[0]
    if len(tri_ids) == 0:
        return None
    p = geometry.positions[tri_ids]  # (L, 3, 3)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    n = np.cross(e1, e2)
    area2 = np.linalg.norm(n, axis=1)  # 2 * area
    unit_n = n / np.maximum(area2[:, None], 1e-30)
    areas = area2 / 2.0
    total = float(areas.sum())
    cdf = np.cumsum(areas) / max(total, 1e-30)
    return LightSet(
        tri=jnp.asarray(tri_ids, jnp.int32),
        v0=jnp.asarray(p[:, 0], jnp.float32),
        e1=jnp.asarray(e1, jnp.float32),
        e2=jnp.asarray(e2, jnp.float32),
        normal=jnp.asarray(unit_n, jnp.float32),
        cdf=jnp.asarray(cdf, jnp.float32),
        total_area=jnp.asarray([total], jnp.float32),
    )


def sample_direct_light(scene, x, n, albedo, throughput, streams, bounce, shaded):
    """One NEE sample per shaded ray.  Returns the radiance contribution
    (R, 3) — zero where ``shaded`` is False, the light faces away, or the
    shadow ray is blocked."""
    from .wavefront import trace_any  # local import: avoid cycle

    lights = scene.lights
    u_sel = rng.uniform(streams, TAG_NEE + 4 * bounce)
    u_a = rng.uniform(streams, TAG_NEE + 4 * bounce + 1)
    u_b = rng.uniform(streams, TAG_NEE + 4 * bounce + 2)
    li = jnp.searchsorted(lights.cdf, u_sel)
    li = jnp.clip(li, 0, lights.cdf.shape[0] - 1)

    # Uniform point on the triangle (sqrt warp).
    su = jnp.sqrt(u_a)
    b1 = (su * (1.0 - u_b))[:, None]
    b2 = (su * u_b)[:, None]
    y = lights.v0[li] + lights.e1[li] * b1 + lights.e2[li] * b2

    wi = y - x
    dist_sq = jnp.sum(wi * wi, axis=-1)
    dist = jnp.sqrt(dist_sq)
    wi = wi / jnp.maximum(dist, 1e-20)[:, None]

    # Unit shading normal: barycentric interpolation shrinks vertex normals
    # on curved meshes, which would silently scale the cosine term.
    n = n * jax.lax.rsqrt(jnp.sum(n * n, axis=-1))[:, None]
    cos_x = jnp.sum(n * wi, axis=-1)
    cos_y = jnp.sum(lights.normal[li] * -wi, axis=-1)
    facing = shaded & (cos_x > 0.0) & (cos_y > 0.0) & (dist_sq > 1e-12)

    # Shadow origin: lift off the surface along the SHADING NORMAL — ``x``
    # arrived offset along the incoming direction (ε *below* the surface),
    # where a two-sided twin quad would self-occlude every shadow ray.
    x = x + n * 1e-4

    # Emitted radiance at y: the light's emissive texture at interpolated uv.
    from ..scene.types import COL_EMIS_DESC, COL_UV

    lrec = scene.shade_table[lights.tri[li]]  # (R, 32)
    uv = lrec[:, COL_UV : COL_UV + 6].reshape(-1, 3, 2)
    w0 = 1.0 - b1 - b2
    tc = uv[:, 0] * w0 + uv[:, 1] * b1 + uv[:, 2] * b2
    le = sample_texture(
        scene.color_data, lrec[:, COL_EMIS_DESC : COL_EMIS_DESC + 7],
        tc[:, 0], tc[:, 1],
    )[:, :3]

    # Shadow ray: any hit closer than the light occludes (the tracer
    # returns the nearest hit, which IS the light triangle when visible).
    t_sh, _, _, _ = trace_any(scene, x, wi, facing)
    visible = facing & (t_sh >= dist * (1.0 - 1e-3))

    # Lambertian albedo/π × Le × G / pdf_area, pdf_area = 1/total_area.
    g_term = cos_x * cos_y / jnp.maximum(dist_sq, 1e-12)
    scale = (g_term * lights.total_area[0] / np.pi)[:, None]
    contrib = throughput * albedo * le * scale
    return jnp.where(visible[:, None], contrib, 0.0)


def pbr_scatter(scene, tri, direction, normal, diffuse_dir, streams, bounce):
    """Metallic-roughness scatter (extension): with probability ``metallic``
    reflect specularly, perturbed by ``roughness``; else the reference's
    diffuse scatter.  Factors come from the glTF pbrMetallicRoughness
    (which the reference parses but ignores)."""
    mr = scene.ext_mr[tri]  # (R, 2): metallic, roughness
    metallic = mr[:, 0]
    roughness = mr[:, 1]
    spec = direction - 2.0 * jnp.sum(direction * normal, axis=-1)[:, None] * normal
    jitter = rng.normal3(streams, TAG_PBR + 2 * bounce)
    spec = linalg.normalize(
        spec + roughness[:, None] * linalg.normalize(jitter)
    )
    # A specular direction below the surface is re-diffused (simple clamp).
    below = jnp.sum(spec * normal, axis=-1) <= 0.0
    u = rng.uniform(streams, TAG_PBR + 2 * bounce + 1)
    take_spec = (u < metallic) & ~below
    return jnp.where(take_spec[:, None], spec, diffuse_dir), take_spec


def roulette(throughput, streams, bounce, alive):
    """Russian roulette from bounce 2 on: survive with p = clamp(max T).
    Unbiased: survivors' throughput divides by p."""
    if bounce < 2:
        return throughput, alive
    p = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
    u = rng.uniform(streams, TAG_RR + bounce)
    survive = u < p
    throughput = throughput / p[:, None]
    return throughput, alive & survive
