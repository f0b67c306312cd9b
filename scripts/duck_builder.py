"""Independent glTF 2.0 exporter + a Duck-class authored asset.

This is a SECOND, standalone glTF writer implemented directly against the
glTF 2.0 specification — it shares no code with the package's
scene/procedural.py SceneBuilder (different container: GLB; different
buffer layout: one INTERLEAVED position+normal+texcoord vertex buffer with
byteStride; u16 indices; textures embedded as PNG bufferViews; node
rotations as quaternions).  A loader bug mirrored into SceneBuilder cannot
hide from assets produced here (the
reference author's manual matrix is Duck.glb / Sponza / AlphaBlendModeTest,
zig_raytracing_contest.sublime-project build_systems).

The asset is a parametric rubber duck (~12k triangles: lathe/UV-sphere
body, head, flattened-cone beak, tail, eyes) with a REAL 512×512 baked
texture (procedural mottled yellow — 262,144 texels, far past the one-hot
fast-path bound, so it exercises the packed-gather shading regime), on a
checker ground inside a lit room.  Camera has an aspectRatio so --height
alone resolves the width, like Duck.glb renders in the reference matrix.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

WRAP_REPEAT = 10497
WRAP_CLAMP = 33071


# ---------------------------------------------------------------------------
# Minimal spec-direct GLB writer.
# ---------------------------------------------------------------------------


class GlbWriter:
    """Accumulates meshes/materials/images and writes a single-buffer GLB."""

    def __init__(self):
        self.bin = bytearray()
        self.buffer_views = []
        self.accessors = []
        self.meshes = []
        self.nodes = []
        self.materials = []
        self.images = []
        self.textures = []
        self.samplers = []
        self.cameras = []
        self.scene_roots = []

    def _align(self, n=4):
        while len(self.bin) % n:
            self.bin.append(0)

    def add_view(self, data: bytes, stride: int | None = None, target=None):
        self._align()
        view = {"buffer": 0, "byteOffset": len(self.bin), "byteLength": len(data)}
        if stride is not None:
            view["byteStride"] = stride
        if target is not None:
            view["target"] = target
        self.bin.extend(data)
        self.buffer_views.append(view)
        return len(self.buffer_views) - 1

    def add_accessor(self, view, comp_type, count, type_, offset=0,
                     minmax=None):
        acc = {
            "bufferView": view,
            "byteOffset": offset,
            "componentType": comp_type,
            "count": count,
            "type": type_,
        }
        if minmax is not None:
            acc["min"], acc["max"] = minmax
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_mesh(self, pos, nrm, uv, indices, material):
        """One primitive from an INTERLEAVED vertex buffer (stride 32:
        3f position + 3f normal + 2f texcoord) and u16 indices."""
        n = pos.shape[0]
        inter = np.empty((n, 8), np.float32)
        inter[:, 0:3] = pos
        inter[:, 3:6] = nrm
        inter[:, 6:8] = uv
        vview = self.add_view(inter.tobytes(), stride=32, target=34962)
        iview = self.add_view(
            np.asarray(indices, np.uint16).tobytes(), target=34963
        )
        a_pos = self.add_accessor(
            vview, 5126, n, "VEC3", 0,
            minmax=(pos.min(0).tolist(), pos.max(0).tolist()),
        )
        a_nrm = self.add_accessor(vview, 5126, n, "VEC3", 12)
        a_uv = self.add_accessor(vview, 5126, n, "VEC2", 24)
        a_idx = self.add_accessor(iview, 5123, len(indices), "SCALAR")
        self.meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {
                            "POSITION": a_pos,
                            "NORMAL": a_nrm,
                            "TEXCOORD_0": a_uv,
                        },
                        "indices": a_idx,
                        "material": material,
                        "mode": 4,
                    }
                ]
            }
        )
        return len(self.meshes) - 1

    def add_node(self, mesh=None, camera=None, translation=None,
                 rotation=None, scale=None, children=None, root=True):
        node = {}
        if mesh is not None:
            node["mesh"] = mesh
        if camera is not None:
            node["camera"] = camera
        if translation is not None:
            node["translation"] = list(map(float, translation))
        if rotation is not None:
            node["rotation"] = list(map(float, rotation))  # xyzw quaternion
        if scale is not None:
            node["scale"] = list(map(float, scale))
        if children is not None:
            node["children"] = children
        self.nodes.append(node)
        idx = len(self.nodes) - 1
        if root:
            self.scene_roots.append(idx)
        return idx

    def add_png_texture(self, rgba: np.ndarray, wrap=WRAP_REPEAT):
        from zig_raytracing_contest_tpu.utils.image_io import encode_png

        view = self.add_view(encode_png(np.ascontiguousarray(rgba)))
        self.images.append({"bufferView": view, "mimeType": "image/png"})
        self.samplers.append({"wrapS": wrap, "wrapT": wrap})
        self.textures.append(
            {"source": len(self.images) - 1, "sampler": len(self.samplers) - 1}
        )
        return len(self.textures) - 1

    def add_material(self, base_factor=None, base_texture=None,
                     emissive=None, alpha_mode=None, alpha_cutoff=None):
        pbr = {}
        if base_factor is not None:
            pbr["baseColorFactor"] = list(map(float, base_factor))
        if base_texture is not None:
            pbr["baseColorTexture"] = {"index": base_texture}
        mat = {"pbrMetallicRoughness": pbr}
        if emissive is not None:
            mat["emissiveFactor"] = list(map(float, emissive))
        if alpha_mode is not None:
            mat["alphaMode"] = alpha_mode
        if alpha_cutoff is not None:
            mat["alphaCutoff"] = float(alpha_cutoff)
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_camera(self, yfov, aspect, znear=0.01, name="DuckCam"):
        self.cameras.append(
            {
                "type": "perspective",
                "perspective": {
                    "yfov": float(yfov),
                    "aspectRatio": float(aspect),
                    "znear": float(znear),
                },
                "name": name,
            }
        )
        return len(self.cameras) - 1

    def write(self, path: Path):
        self._align()
        doc = {
            "asset": {"version": "2.0", "generator": "duck_builder (spec-direct)"},
            "scene": 0,
            "scenes": [{"nodes": self.scene_roots}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "accessors": self.accessors,
            "bufferViews": self.buffer_views,
            "buffers": [{"byteLength": len(self.bin)}],
            "materials": self.materials,
        }
        if self.images:
            doc["images"] = self.images
            doc["samplers"] = self.samplers
            doc["textures"] = self.textures
        if self.cameras:
            doc["cameras"] = self.cameras
        js = json.dumps(doc, separators=(",", ":")).encode()
        js += b" " * (-len(js) % 4)
        total = 12 + 8 + len(js) + 8 + len(self.bin)
        out = bytearray()
        out += struct.pack("<III", 0x46546C67, 2, total)
        out += struct.pack("<II", len(js), 0x4E4F534A) + js
        out += struct.pack("<II", len(self.bin), 0x004E4942) + bytes(self.bin)
        Path(path).write_bytes(out)
        return Path(path)


# ---------------------------------------------------------------------------
# Parametric duck geometry.
# ---------------------------------------------------------------------------


def uv_sphere(nu=48, nv=32, radii=(1, 1, 1), squash=None):
    """Lat-long sphere: positions, normals, uvs, u16 indices."""
    u = np.linspace(0, 2 * np.pi, nu + 1)
    v = np.linspace(0, np.pi, nv + 1)
    uu, vv = np.meshgrid(u, v)
    x = np.cos(uu) * np.sin(vv)
    y = np.cos(vv)
    z = np.sin(uu) * np.sin(vv)
    p = np.stack([x, y, z], -1)
    if squash is not None:
        p = squash(p)
    pos = (p * np.asarray(radii)).reshape(-1, 3).astype(np.float32)
    # Exact normals of the scaled sphere: n ∝ p / radii² (gradient of the
    # implicit ellipsoid); good enough for squashed variants too.
    nrm = (p / np.square(np.asarray(radii))).reshape(-1, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    uvs = np.stack([uu / (2 * np.pi), vv / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for j in range(nv):
        for i in range(nu):
            a = j * (nu + 1) + i
            b = a + nu + 1
            idx += [a, b, a + 1, a + 1, b, b + 1]
    return pos, nrm, uvs, np.asarray(idx, np.uint16)


def cone(nu=24, length=1.0, r0=0.35, r1=0.02, flatten=1.0):
    """Open cone along +x with vertical flattening (beak/tail)."""
    u = np.linspace(0, 2 * np.pi, nu + 1)
    xs = np.linspace(0, length, 8)
    uu, xx = np.meshgrid(u, xs)
    r = r0 + (r1 - r0) * (xx / length)
    y = np.cos(uu) * r * flatten
    z = np.sin(uu) * r
    pos = np.stack([xx, y, z], -1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack(
        [np.full_like(uu, (r0 - r1) / length), np.cos(uu) / max(flatten, 1e-3),
         np.sin(uu)], -1
    ).reshape(-1, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    uvs = np.stack([uu / (2 * np.pi), xx / length], -1).reshape(-1, 2).astype(
        np.float32
    )
    idx = []
    for j in range(7):
        for i in range(nu):
            a = j * (nu + 1) + i
            b = a + nu + 1
            idx += [a, a + 1, b, a + 1, b + 1, b]
    return pos, nrm, uvs, np.asarray(idx, np.uint16)


def quad_mesh(center, uax, vax, uv_scale=1.0):
    c = np.asarray(center, np.float32)
    ua = np.asarray(uax, np.float32)
    va = np.asarray(vax, np.float32)
    pos = np.stack([c - ua - va, c + ua - va, c + ua + va, c - ua + va])
    n = np.cross(ua, va)
    n = (n / np.linalg.norm(n)).astype(np.float32)
    nrm = np.tile(n, (4, 1))
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    return pos, nrm, uvs, np.asarray([0, 1, 2, 0, 2, 3], np.uint16)


def duck_texture(size=512, seed=11):
    """Mottled-yellow 512×512 body texture (value-noise octaves)."""
    r = np.random.default_rng(seed)
    acc = np.zeros((size, size))
    for octave in (8, 16, 32, 64):
        grid = r.uniform(-1, 1, (octave + 1, octave + 1))
        ys = np.linspace(0, octave, size, endpoint=False)
        xs = np.linspace(0, octave, size, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = (
            grid[y0][:, x0] * (1 - fy) * (1 - fx)
            + grid[y0][:, x0 + 1] * (1 - fy) * fx
            + grid[y0 + 1][:, x0] * fy * (1 - fx)
            + grid[y0 + 1][:, x0 + 1] * fy * fx
        )
        acc += g * (8.0 / octave)
    acc /= np.abs(acc).max()
    rgba = np.empty((size, size, 4), np.uint8)
    rgba[..., 0] = np.clip(235 + 18 * acc, 0, 255)
    rgba[..., 1] = np.clip(200 + 34 * acc, 0, 255)
    rgba[..., 2] = np.clip(40 + 28 * acc, 0, 255)
    rgba[..., 3] = 255
    return rgba


def checker_texture(size=256):
    t = np.zeros((size, size, 4), np.uint8)
    c = ((np.arange(size)[:, None] // 32 + np.arange(size)[None, :] // 32) % 2
         ).astype(bool)
    t[c] = [200, 205, 210, 255]
    t[~c] = [70, 80, 95, 255]
    t[..., 3] = 255
    return t


def write_duck_glb(path, tex_size=512, detail=1.0):
    """Write the Duck-class GLB.  ~12k triangles at detail=1."""
    w = GlbWriter()
    duck_tex = w.add_png_texture(duck_texture(tex_size), wrap=WRAP_REPEAT)
    floor_tex = w.add_png_texture(checker_texture(), wrap=WRAP_REPEAT)
    body_mat = w.add_material(base_texture=duck_tex)
    beak_mat = w.add_material(base_factor=(0.95, 0.45, 0.08, 1.0))
    eye_mat = w.add_material(base_factor=(0.05, 0.05, 0.06, 1.0))
    floor_mat = w.add_material(base_texture=floor_tex)
    wall_mat = w.add_material(base_factor=(0.62, 0.64, 0.68, 1.0))
    light_mat = w.add_material(
        base_factor=(0, 0, 0, 1), emissive=(7.0, 6.6, 6.0)
    )

    def seg(n):
        return max(8, int(n * detail))

    def body_squash(p):
        # Egg the body: widen the chest, taper the rear, lift the breast.
        q = p.copy()
        q[..., 1] += 0.18 * np.clip(p[..., 0], 0, 1) ** 2
        q[..., 2] *= 1.0 - 0.15 * np.clip(-p[..., 0], 0, 1)
        return q

    parts = []  # (mesh arrays, material, node TRS)
    parts.append(
        (
            uv_sphere(seg(64), seg(40), radii=(1.35, 0.95, 1.05),
                      squash=body_squash),
            body_mat,
            dict(translation=(0, 0.95, 0)),
        )
    )
    parts.append(
        (
            uv_sphere(seg(48), seg(32), radii=(0.52, 0.55, 0.48)),
            body_mat,
            dict(translation=(0.95, 1.95, 0)),
        )
    )
    parts.append(
        (
            cone(seg(24), length=0.55, r0=0.27, r1=0.05, flatten=0.45),
            beak_mat,
            dict(translation=(1.32, 1.85, 0)),
        )
    )
    parts.append(
        (
            cone(seg(20), length=0.7, r0=0.3, r1=0.03, flatten=0.8),
            body_mat,
            # tail: rotated 150° about z (pointing back-up), quaternion xyzw
            dict(
                translation=(-1.15, 1.25, 0),
                rotation=(0, 0, float(np.sin(2.62 / 2)), float(np.cos(2.62 / 2))),
            ),
        )
    )
    for side in (-1, 1):
        parts.append(
            (
                uv_sphere(seg(16), seg(12), radii=(0.07, 0.07, 0.07)),
                eye_mat,
                dict(translation=(1.25, 2.12, 0.27 * side)),
            )
        )

    duck_children = []
    for (pos, nrm, uvs, idx), mat, trs in parts:
        mesh = w.add_mesh(pos, nrm, uvs, idx, mat)
        duck_children.append(w.add_node(mesh=mesh, root=False, **trs))
    # Whole duck under one node: rotated 35° about Y, scaled 1.2.
    ang = np.deg2rad(35.0)
    w.add_node(
        children=duck_children,
        rotation=(0, float(np.sin(ang / 2)), 0, float(np.cos(ang / 2))),
        scale=(1.2, 1.2, 1.2),
    )

    # Room: textured floor, walls, ceiling light.
    S = 7.0
    for center, ua, va, mat, uv_s in [
        ((0, 0, 0), (S, 0, 0), (0, 0, -S), floor_mat, 6.0),
        ((0, 6.5, 0), (2.5, 0, 0), (0, 0, 2.5), light_mat, 1.0),
        ((0, 3, -S), (S, 0, 0), (0, 3.5, 0), wall_mat, 1.0),
        ((-S, 3, 0), (0, 0, S), (0, 3.5, 0), wall_mat, 1.0),
        ((S, 3, 0), (0, 0, -S), (0, 3.5, 0), wall_mat, 1.0),
    ]:
        pos, nrm, uvs, idx = quad_mesh(center, ua, va, uv_s)
        w.add_node(mesh=w.add_mesh(pos, nrm, uvs, idx, mat))

    # Camera: positioned at +z looking at the duck, aspect 16:9 so
    # --height alone resolves width (Duck.glb-style).
    cam = w.add_camera(yfov=0.7, aspect=16 / 9)
    eye = np.asarray([4.2, 3.0, 5.5])
    target = np.asarray([0, 1.3, 0])
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    # Camera -z axis = fwd (glTF convention); build the node rotation.
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    m = np.stack([right, up, -fwd], axis=1)  # columns = camera axes
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    qw = np.sqrt(max(0.0, 1 + tr)) / 2
    qx = (m[2, 1] - m[1, 2]) / (4 * qw)
    qy = (m[0, 2] - m[2, 0]) / (4 * qw)
    qz = (m[1, 0] - m[0, 1]) / (4 * qw)
    w.add_node(camera=cam, translation=eye.tolist(),
               rotation=(float(qx), float(qy), float(qz), float(qw)))

    return w.write(path)


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/duck.glb"
    p = write_duck_glb(out)
    print(f"wrote {p} ({p.stat().st_size} bytes)")
