"""Device-side scene representation: flat SoA jnp arrays.

Device analogue of the reference's baked Scene (src/stage3.zig:136-141):
grid + [begin, end) cell ranges + SoA triangles.  Hot-path position data
(Möller–Trumbore precomputed v0/e1/e2, src/linalg.zig:688-694) is duplicated
per overlapping cell in DDA-visit order exactly like bakeInto
(src/stage2.zig:137-164).

Shading data is one (T, 32) f32 record per unique triangle packing vertex
normals (9), vertex uvs (6), the base-color texture descriptor (8) and the
emissive descriptor (8) — so the shading stage is ONE row gather plus two
bilinear texture lookups from the unified RGBA bank.  Descriptor ints are
stored as f32; repeat-mode sentinel bounds are clamped to ±2^30 (exactly
representable, still larger than any real texel coordinate after the
sampler's own safety clamp).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..grid.builder import GridBuild
from ..ops.dda import GridParams
from ..ops.mxu_intersect import TRI_TILE, MXUTriangles, bake_triangles
from .geometry import GeometryArrays
from .materials import MaterialBank

# shade_table column layout
COL_NRM = 0  # 9 cols: 3 vertices × xyz (world, normalized)
COL_UV = 9  # 6 cols: 3 vertices × uv
COL_BASE_DESC = 15  # 8 cols: base-color descriptor (f32-encoded) + dequant scale
COL_EMIS_DESC = 23  # 8 cols: emissive descriptor + dequant scale
DESC_SCALE = 7  # descriptor col: u16 dequant multiplier (texture peak / 65535)
SHADE_COLS = 32

_DESC_SENTINEL = float(1 << 30)


class DeviceScene(NamedTuple):
    grid: GridParams
    cell_begin: jnp.ndarray  # (C,) int32
    cell_end: jnp.ndarray  # (C,) int32
    # Hot intersection data — duplicated per cell reference, DDA order:
    tri_v0: jnp.ndarray  # (D, 3) f32
    tri_e1: jnp.ndarray  # (D, 3) f32
    tri_e2: jnp.ndarray  # (D, 3) f32
    dup_to_tri: jnp.ndarray  # (D,) int32
    # Unique-triangle shading records + unified RGBA texture bank
    # (texel fetches are (R, 4) row gathers).
    shade_table: jnp.ndarray  # (T, 32) f32
    color_data: jnp.ndarray  # (P, 4) f32 (channel 3 = opacity semantics)
    # Baked bank for brute-force tracing (None → grid DDA is used):
    mxu: MXUTriangles | None = None
    # Extension data (render/extensions.py; the reference has none of this):
    # emissive-triangle sampling table for NEE, and per-unique-triangle
    # (metallic, roughness) factors for the pbr scatter.
    lights: object | None = None  # LightSet
    ext_mr: jnp.ndarray | None = None  # (T, 2) f32


def _build_lights(geometry, materials):
    from ..render.extensions import build_light_set

    if geometry.num_triangles == 0:
        return None
    return build_light_set(geometry, materials)


def _desc_to_f32(desc_rows: np.ndarray) -> np.ndarray:
    d = desc_rows.astype(np.float64)
    return np.clip(d, -_DESC_SENTINEL, _DESC_SENTINEL).astype(np.float32)


def build_shade_table(geometry: GeometryArrays, materials: MaterialBank) -> np.ndarray:
    if materials.color_data.shape[0] > 1 << 24:
        # Texture descriptors ride the shade table as f32; offsets past 2^24
        # would silently round to the wrong texel.
        raise ValueError(
            f"texel bank has {materials.color_data.shape[0]} texels; f32 "
            f"descriptor offsets are exact only below 2^24 (~two 4K×4K "
            f"textures). Reduce texture resolution."
        )
    T = geometry.num_triangles
    table = np.zeros((T, SHADE_COLS), np.float32)
    table[:, COL_NRM : COL_NRM + 9] = geometry.normals.reshape(T, 9)
    table[:, COL_UV : COL_UV + 6] = geometry.texcoords.reshape(T, 6)
    mat = geometry.material_idx
    base = materials.mat_base[mat]
    emis = materials.mat_emissive[mat]
    table[:, COL_BASE_DESC : COL_BASE_DESC + 7] = _desc_to_f32(
        materials.color_desc[base]
    )
    table[:, COL_EMIS_DESC : COL_EMIS_DESC + 7] = _desc_to_f32(
        materials.color_desc[emis]
    )
    if materials.color_scale is not None:
        table[:, COL_BASE_DESC + DESC_SCALE] = materials.color_scale[base]
        table[:, COL_EMIS_DESC + DESC_SCALE] = materials.color_scale[emis]
    return table


def build_device_scene(
    geometry: GeometryArrays,
    grid: GridBuild,
    materials: MaterialBank,
    backend: str = "auto",
) -> DeviceScene:
    """backend: 'auto' | 'mxu' | 'grid'.  'mxu' bakes the triangle bank
    for brute-force tracing with box culls, 'grid' traces through the grid
    DDA.  'auto' is the bank: on an H100 the bank's trace kernel rendered
    both the 804-triangle contest scene and the 100k-triangle terrain
    faster end to end than the grid DDA (PERF.md), so no triangle count
    switches to the grid."""
    if backend not in ("auto", "mxu", "grid"):
        raise ValueError(f"unknown backend {backend!r}")
    use_bank = backend != "grid"

    dup = grid.dup_to_tri.astype(np.int64)
    p0 = geometry.positions[dup, 0]
    p1 = geometry.positions[dup, 1]
    p2 = geometry.positions[dup, 2]

    # Pad the duplicated arrays so D is never 0 and gathers stay in range;
    # padded entries are unreachable (cell ranges never point at them).
    def pad1(a):
        return np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)], axis=0)

    bank = (
        bake_triangles(
            geometry.positions[:, 0],
            geometry.positions[:, 1] - geometry.positions[:, 0],
            geometry.positions[:, 2] - geometry.positions[:, 0],
            tile=TRI_TILE,
        )
        if use_bank
        else None
    )
    return DeviceScene(
        grid=GridParams(
            bbox_min=jnp.asarray(grid.bbox_min, jnp.float32),
            bbox_max=jnp.asarray(grid.bbox_max, jnp.float32),
            resolution=jnp.asarray(grid.resolution, jnp.int32),
            cell_size=jnp.asarray(grid.cell_size, jnp.float32),
        ),
        cell_begin=jnp.asarray(grid.cell_begin, jnp.int32),
        cell_end=jnp.asarray(grid.cell_end, jnp.int32),
        tri_v0=jnp.asarray(pad1(p0), jnp.float32),
        tri_e1=jnp.asarray(pad1(p1 - p0), jnp.float32),
        tri_e2=jnp.asarray(pad1(p2 - p0), jnp.float32),
        dup_to_tri=jnp.asarray(pad1(grid.dup_to_tri), jnp.int32),
        shade_table=jnp.asarray(build_shade_table(geometry, materials)),
        color_data=jnp.asarray(materials.color_data, jnp.float32),
        mxu=bank,
        lights=_build_lights(geometry, materials),
        ext_mr=(
            jnp.asarray(
                np.stack(
                    [
                        materials.mat_metallic[geometry.material_idx],
                        materials.mat_roughness[geometry.material_idx],
                    ],
                    axis=-1,
                ),
                jnp.float32,
            )
            if materials.mat_metallic is not None
            and geometry.num_triangles > 0
            else None
        ),
    )
