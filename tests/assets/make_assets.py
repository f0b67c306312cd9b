"""One-off generator for the committed golden-test glTF assets.

Deliberately independent of zig_raytracing_contest_tpu.scene.procedural:
these files exercise the loader from a second authoring path (raw glTF JSON
+ hand-packed little-endian buffers + data URIs), so a bug mirrored between
SceneBuilder and the loader stays visible.  The
two scenes correspond to the reference author's manual test list
(zig_raytracing_contest.sublime-project): a Duck-class textured mesh and an
AlphaBlendModeTest-class scene (OPAQUE / MASK / BLEND side by side).

Run from the repo root to regenerate:  python tests/assets/make_assets.py
"""

from __future__ import annotations

import base64
import io
import json
import struct
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).parent


def b64uri(data: bytes, mime="application/octet-stream") -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


def png_bytes(arr: np.ndarray) -> bytes:
    mode = {3: "RGB", 4: "RGBA"}[arr.shape[2]]
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def pack_floats(vals) -> bytes:
    flat = np.asarray(vals, np.float32).reshape(-1)
    return struct.pack(f"<{flat.size}f", *flat.tolist())


def pack_u16(vals) -> bytes:
    flat = np.asarray(vals, np.uint16).reshape(-1)
    return struct.pack(f"<{flat.size}H", *flat.tolist())


class RawGltf:
    """Minimal raw-JSON glTF assembler (one buffer, data-URI everything)."""

    def __init__(self):
        self.doc = {
            "asset": {"version": "2.0"},
            "scene": 0,
            "scenes": [{"nodes": []}],
            "nodes": [],
            "meshes": [],
            "materials": [],
            "cameras": [],
            "accessors": [],
            "bufferViews": [],
            "buffers": [],
            "images": [],
            "samplers": [],
            "textures": [],
        }
        self.blob = b""

    def view(self, data: bytes) -> int:
        # 4-byte align every view start (accessor componentType alignment).
        pad = -len(self.blob) % 4
        self.blob += b"\0" * pad
        self.doc["bufferViews"].append(
            {"buffer": 0, "byteOffset": len(self.blob), "byteLength": len(data)}
        )
        self.blob += data
        return len(self.doc["bufferViews"]) - 1

    def accessor(self, view, ctype, count, type_, vmin=None, vmax=None) -> int:
        acc = {
            "bufferView": view,
            "componentType": ctype,
            "count": count,
            "type": type_,
        }
        if vmin is not None:
            acc["min"], acc["max"] = vmin, vmax
        self.doc["accessors"].append(acc)
        return len(self.doc["accessors"]) - 1

    def vec3_accessor(self, arr) -> int:
        arr = np.asarray(arr, np.float32).reshape(-1, 3)
        return self.accessor(
            self.view(pack_floats(arr)), 5126, len(arr), "VEC3",
            arr.min(0).tolist(), arr.max(0).tolist(),
        )

    def vec2_accessor(self, arr) -> int:
        arr = np.asarray(arr, np.float32).reshape(-1, 2)
        return self.accessor(self.view(pack_floats(arr)), 5126, len(arr), "VEC2")

    def index_accessor(self, idx) -> int:
        idx = np.asarray(idx, np.uint16).reshape(-1)
        return self.accessor(self.view(pack_u16(idx)), 5123, len(idx), "SCALAR")

    def texture(self, img_u8: np.ndarray, wrap=10497) -> int:
        self.doc["images"].append({"uri": b64uri(png_bytes(img_u8), "image/png")})
        self.doc["samplers"].append({"wrapS": wrap, "wrapT": wrap})
        self.doc["textures"].append(
            {"source": len(self.doc["images"]) - 1,
             "sampler": len(self.doc["samplers"]) - 1}
        )
        return len(self.doc["textures"]) - 1

    def mesh_node(self, prim: dict, name: str, translation=None) -> int:
        self.doc["meshes"].append({"primitives": [prim]})
        node = {"mesh": len(self.doc["meshes"]) - 1, "name": name}
        if translation is not None:
            node["translation"] = list(translation)
        self.doc["nodes"].append(node)
        i = len(self.doc["nodes"]) - 1
        self.doc["scenes"][0]["nodes"].append(i)
        return i

    def camera_node(self, translation, rotation, yfov, name, aspect=None) -> int:
        cam = {"type": "perspective", "name": name,
               "perspective": {"yfov": yfov, "znear": 0.01}}
        if aspect is not None:
            cam["perspective"]["aspectRatio"] = aspect
        self.doc["cameras"].append(cam)
        self.doc["nodes"].append(
            {"camera": len(self.doc["cameras"]) - 1, "name": name,
             "translation": list(translation), "rotation": list(rotation)}
        )
        i = len(self.doc["nodes"]) - 1
        self.doc["scenes"][0]["nodes"].append(i)
        return i

    def write(self, path: Path):
        self.doc["buffers"] = [
            {"byteLength": len(self.blob), "uri": b64uri(self.blob)}
        ]
        path.write_text(json.dumps(self.doc, indent=1))


def grid_patch(nx, nz, y_fn, size=2.0):
    """(nx+1)×(nz+1) height-field patch — vertex data a SceneBuilder quad
    can't produce (shared vertices, non-planar)."""
    xs = np.linspace(-size, size, nx + 1)
    zs = np.linspace(-size, size, nz + 1)
    pos, uv = [], []
    for z in zs:
        for x in xs:
            pos.append([x, y_fn(x, z), z])
            uv.append([(x + size) / (2 * size) * 3, (z + size) / (2 * size) * 3])
    idx = []
    for j in range(nz):
        for i in range(nx):
            a = j * (nx + 1) + i
            b = a + 1
            c = a + nx + 1
            d = c + 1
            idx += [a, c, b, b, c, d]
    pos = np.asarray(pos, np.float32)
    # area-weighted vertex normals
    nrm = np.zeros_like(pos)
    tri = np.asarray(idx).reshape(-1, 3)
    fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]], pos[tri[:, 2]] - pos[tri[:, 0]])
    for k in range(3):
        np.add.at(nrm, tri[:, k], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    return pos, np.asarray(uv, np.float32), np.asarray(idx, np.uint16), nrm


def make_duckish(path: Path):
    """Duck-class: one textured smooth height-field mesh + untextured ground,
    camera WITH aspectRatio (exercises the height-only CLI path)."""
    g = RawGltf()

    # 8×8 checker-ish plasma texture, repeat wrap.
    yy, xx = np.mgrid[0:16, 0:16]
    tex = np.stack(
        [
            (np.sin(xx * 0.9) * 100 + 130).astype(np.uint8),
            (np.cos(yy * 0.7) * 90 + 120).astype(np.uint8),
            ((xx // 4 + yy // 4) % 2 * 160 + 60).astype(np.uint8),
        ],
        axis=-1,
    )
    t0 = g.texture(tex, wrap=10497)
    g.doc["materials"].append(
        {
            "name": "skin",
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": t0},
                "baseColorFactor": [1.0, 0.9, 0.6, 1.0],
            },
        }
    )
    g.doc["materials"].append(
        {"name": "ground",
         "pbrMetallicRoughness": {"baseColorFactor": [0.3, 0.45, 0.3, 1.0]}}
    )

    pos, uv, idx, nrm = grid_patch(6, 6, lambda x, z: 0.9 * np.exp(-(x * x + z * z) / 1.8))
    g.mesh_node(
        {
            "attributes": {
                "POSITION": g.vec3_accessor(pos),
                "NORMAL": g.vec3_accessor(nrm),
                "TEXCOORD_0": g.vec2_accessor(uv),
            },
            "indices": g.index_accessor(idx),
            "material": 0,
            "mode": 4,
        },
        "bump",
    )
    gp = np.asarray(
        [[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]], np.float32
    )
    g.mesh_node(
        {
            "attributes": {
                "POSITION": g.vec3_accessor(gp),
                "NORMAL": g.vec3_accessor(np.tile([0, 1, 0], (4, 1))),
                "TEXCOORD_0": g.vec2_accessor(np.zeros((4, 2))),
            },
            "indices": g.index_accessor([0, 2, 1, 0, 3, 2]),
            "material": 1,
            "mode": 4,
        },
        "ground",
    )
    # Camera at (0, 2.2, 4.6) pitched down ~24°: quaternion about x.
    ang = -0.42
    g.camera_node(
        (0, 2.2, 4.6),
        (np.sin(ang / 2), 0, 0, np.cos(ang / 2)),
        yfov=0.7,
        name="main",
        aspect=1.5,
    )
    g.write(path)


def make_alpha_modes(path: Path):
    """AlphaBlendModeTest-class: the same RGBA texture applied as OPAQUE,
    MASK (cutoff 0.5) and BLEND on three quads over a bright backdrop."""
    g = RawGltf()

    # Radial alpha ramp texture (opaque center, transparent edge).
    yy, xx = np.mgrid[0:32, 0:32]
    r = np.sqrt((xx - 15.5) ** 2 + (yy - 15.5) ** 2) / 16.0
    alpha = np.clip(255 * (1.15 - r), 0, 255).astype(np.uint8)
    rgba = np.stack(
        [
            np.full_like(alpha, 200),
            (xx * 7).astype(np.uint8),
            (yy * 7).astype(np.uint8),
            alpha,
        ],
        axis=-1,
    )
    t = g.texture(rgba, wrap=33071)  # clamp

    for mi, (name, extra) in enumerate(
        [
            ("opaque", {}),
            ("mask", {"alphaMode": "MASK", "alphaCutoff": 0.5}),
            ("blend", {"alphaMode": "BLEND"}),
        ]
    ):
        g.doc["materials"].append(
            {
                "name": name,
                "pbrMetallicRoughness": {"baseColorTexture": {"index": t}},
                **extra,
            }
        )

    g.doc["materials"].append(
        {"name": "backdrop",
         "pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.85, 0.2, 1.0]}}
    )
    g.doc["materials"].append(
        {"name": "lamp",
         "pbrMetallicRoughness": {"baseColorFactor": [0, 0, 0, 1]},
         "emissiveFactor": [1.0, 1.0, 1.0]}
    )

    def quad_prim(material, half=0.9):
        p = np.asarray(
            [[-half, -half, 0], [half, -half, 0], [half, half, 0], [-half, half, 0]],
            np.float32,
        )
        return {
            "attributes": {
                "POSITION": g.vec3_accessor(p),
                "NORMAL": g.vec3_accessor(np.tile([0, 0, 1], (4, 1))),
                "TEXCOORD_0": g.vec2_accessor(
                    [[0, 1], [1, 1], [1, 0], [0, 0]]
                ),
            },
            "indices": g.index_accessor([0, 1, 2, 0, 2, 3]),
            "material": material,
            "mode": 4,
        }

    for mi, x in [(0, -2.2), (1, 0.0), (2, 2.2)]:
        g.mesh_node(quad_prim(mi), f"quad_{mi}", translation=(x, 0.0, 0.0))
    # Backdrop behind (material 3) and an emissive ceiling strip (4).
    bp = np.asarray(
        [[-4.5, -2, -1.5], [4.5, -2, -1.5], [4.5, 2, -1.5], [-4.5, 2, -1.5]],
        np.float32,
    )
    g.mesh_node(
        {
            "attributes": {
                "POSITION": g.vec3_accessor(bp),
                "NORMAL": g.vec3_accessor(np.tile([0, 0, 1], (4, 1))),
                "TEXCOORD_0": g.vec2_accessor(np.zeros((4, 2))),
            },
            "indices": g.index_accessor([0, 1, 2, 0, 2, 3]),
            "material": 3,
            "mode": 4,
        },
        "backdrop",
    )
    lp = np.asarray(
        [[-4, 2.4, 1.2], [4, 2.4, 1.2], [4, 2.4, -1.2], [-4, 2.4, -1.2]],
        np.float32,
    )
    g.mesh_node(
        {
            "attributes": {
                "POSITION": g.vec3_accessor(lp),
                "NORMAL": g.vec3_accessor(np.tile([0, -1, 0], (4, 1))),
                "TEXCOORD_0": g.vec2_accessor(np.zeros((4, 2))),
            },
            "indices": g.index_accessor([0, 1, 2, 0, 2, 3]),
            "material": 4,
            "mode": 4,
        },
        "lamp",
    )
    # Straight-on camera, no aspectRatio (exercises width+height CLI path).
    g.camera_node((0, 0, 5.5), (0, 0, 0, 1), yfov=0.75, name="front")
    g.write(path)


if __name__ == "__main__":
    make_duckish(HERE / "duckish.gltf")
    make_alpha_modes(HERE / "alpha_modes.gltf")
    print("wrote", HERE / "duckish.gltf", "and", HERE / "alpha_modes.gltf")
