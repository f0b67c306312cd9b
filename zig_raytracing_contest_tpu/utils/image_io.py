"""Host-side image decode/encode with stb-compatible semantics.

The reference decodes textures with ``stbi_loadf_from_memory(..., 4)``
(src/stage1.zig:58-64): every image becomes float RGBA where 8-bit color
channels are linearized as ``(x/255)^2.2`` (stb's ldr_to_hdr, gamma 2.2,
scale 1.0) and alpha stays linear ``a/255``; 16-bit sources are reduced to
8-bit first (stb keeps the high byte).  ``actual_c`` is the source channel
count before forcing RGBA — the alpha-texture path keys off it
(src/stage1.zig:452).

PNG is decoded and encoded here with numpy and zlib alone: bit depths 1-16,
grey, grey+alpha, RGB, RGBA and palette (with ``tRNS`` transparency), all
five scanline filters.  Other formats (JPEG) go through Pillow, imported
only when such a texture appears.

PNG output mirrors ``stbi_write_png`` of packed 3-byte RGB rows
(src/main.zig:130-139).
"""

from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass

import numpy as np

LDR_GAMMA = 2.2  # stb default stbi_ldr_to_hdr_gamma

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type → samples
_GREY_SCALE = {1: 0xFF, 2: 0x55, 4: 0x11, 8: 1}  # stb's low-depth expansion

_MODE_CHANNELS = {
    "1": 1,
    "L": 1,
    "I": 1,
    "I;16": 1,
    "F": 1,
    "LA": 2,
    "P": 3,  # overridden to 4 below when the palette carries transparency
    "RGB": 3,
    "RGBA": 4,
    "PA": 2,
}


@dataclass
class DecodedImage:
    """f32 RGBA pixels, gamma-linearized, plus the source channel count."""

    width: int
    height: int
    actual_c: int  # channels in the source file (1/2/3/4)
    pixels: np.ndarray  # (height * width, 4) float32, row-major from the top


def _unfilter(raw: np.ndarray, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters: (h, rowbytes) uint8.

    Pixel (r, i) depends on its left, upper and upper-left neighbours, so
    every anti-diagonal r + i = k is reconstructed at once, whatever filter
    each row uses."""
    rows = raw.reshape(h, rowbytes + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    cols = rowbytes // bpp
    filt = rows[:, 1:].reshape(h, cols, bpp).astype(np.int32)
    out = np.zeros((h + 1, cols + 1, bpp), np.int32)  # zero row/col border
    for k in range(h + cols - 1):
        r = np.arange(max(0, k - cols + 1), min(h, k + 1))
        i = k - r
        x = filt[r, i]
        a = out[r + 1, i]  # left
        b = out[r, i + 1]  # up
        c = out[r, i]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = ftype[r][:, None]
        pred = np.select(
            [ft == 1, ft == 2, ft == 3, ft == 4],
            [a, b, (a + b) >> 1, paeth],
            0,
        )
        out[r + 1, i + 1] = (x + pred) & 0xFF
    return out[1:, 1:].reshape(h, rowbytes).astype(np.uint8)


def _unpack_samples(rows: np.ndarray, w: int, depth: int, samples: int):
    """(h, rowbytes) uint8 → (h, w, samples) integer samples."""
    h = rows.shape[0]
    n = w * samples
    if depth == 16:
        pairs = rows[:, : 2 * n].reshape(h, n, 2).astype(np.uint16)
        return ((pairs[..., 0] << 8) | pairs[..., 1]).reshape(h, w, samples)
    if depth == 8:
        return rows[:, :n].reshape(h, w, samples)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :n].reshape(h, w, samples)


def read_png(data: bytes) -> np.ndarray:
    """Decode a PNG to (h, w, c) uint8: c is 1 (grey), 2 (grey+alpha),
    3 (RGB, or a palette without transparency) or 4 (RGBA, or a palette
    with transparency).  A tRNS key colour on grey or RGB adds an alpha
    channel (c = 2 or 4).  16-bit samples keep their high byte."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(PNG_SIGNATURE)
    ihdr = plte = trns = None
    idat = []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced (Adam7) PNGs are not supported")
    if ctype not in _COLOR_CHANNELS or depth not in (1, 2, 4, 8, 16) or (
        ctype in (2, 4, 6) and depth < 8
    ) or (ctype == 3 and depth == 16):
        raise ValueError(f"unsupported PNG: color type {ctype}, depth {depth}")
    samples = _COLOR_CHANNELS[ctype]
    bpp = max(1, samples * depth // 8)
    rowbytes = (w * samples * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (rowbytes + 1):
        raise ValueError("truncated PNG image data")
    rows = _unfilter(raw[: h * (rowbytes + 1)], h, rowbytes, bpp)
    vals = _unpack_samples(rows, w, depth, samples)

    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        idx = vals[..., 0].astype(np.intp)
        if idx.max(initial=0) >= len(plte):
            raise ValueError("palette index out of range")
        if trns is None:
            return plte[idx]
        alpha = np.full(len(plte), 255, np.uint8)
        t = np.frombuffer(trns, np.uint8)[: len(plte)]
        alpha[: len(t)] = t
        return np.concatenate([plte[idx], alpha[idx][..., None]], axis=-1)

    key = None
    if trns is not None and ctype in (0, 2):
        key = np.asarray(struct.unpack(f">{samples}H", trns[: 2 * samples]))
    if depth == 16:
        out = (vals >> 8).astype(np.uint8)
    else:
        out = (vals * _GREY_SCALE[depth] if ctype == 0 else vals).astype(np.uint8)
    if key is not None:
        opaque = ~np.all(vals == key, axis=-1)
        out = np.concatenate(
            [out, np.where(opaque, 255, 0).astype(np.uint8)[..., None]], axis=-1
        )
    return out


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body)) + kind + body
        + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    )


def encode_png(pixels: np.ndarray) -> bytes:
    """(h, w, c) uint8 → 8-bit PNG bytes (c = 1 grey, 2 grey+alpha, 3 RGB,
    4 RGBA), every scanline with the Sub filter."""
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] not in (
        1, 2, 3, 4
    ):
        raise ValueError(
            f"expected (h, w, 1-4) uint8, got {pixels.shape} {pixels.dtype}"
        )
    h, w, c = pixels.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = pixels.reshape(h, w * c)
    sub = rows.copy()
    sub[:, c:] = rows[:, c:] - rows[:, :-c]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    return (
        PNG_SIGNATURE
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def _linearize(rgba_u8: np.ndarray, actual_c: int) -> DecodedImage:
    u8 = np.asarray(rgba_u8, dtype=np.float32) / 255.0  # (h, w, 4)
    out = np.empty_like(u8)
    out[..., :3] = u8[..., :3] ** LDR_GAMMA
    out[..., 3] = u8[..., 3]
    h, w = out.shape[:2]
    return DecodedImage(w, h, actual_c, out.reshape(h * w, 4).astype(np.float32))


def _decode_png(data: bytes) -> DecodedImage:
    px = read_png(data)
    c = px.shape[2]
    ctype = data[25]  # IHDR colour type
    # stb reports the file's own channel count: a grey or RGB key colour
    # (tRNS) adds alpha but not a channel; a transparent palette is 4.
    actual_c = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype, c)
    if c <= 2:
        grey = np.repeat(px[..., :1], 3, axis=-1)
        alpha = px[..., 1:2] if c == 2 else np.full_like(px[..., :1], 255)
        px = np.concatenate([grey, alpha], axis=-1)
    elif c == 3:
        px = np.concatenate([px, np.full_like(px[..., :1], 255)], axis=-1)
    return _linearize(px, actual_c)


def _decode_pillow(data: bytes) -> DecodedImage:
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            "decoding non-PNG textures (e.g. JPEG) needs the Pillow package"
        ) from exc
    img = Image.open(io.BytesIO(data))
    mode = img.mode
    actual_c = _MODE_CHANNELS.get(mode, 3)
    if mode == "P":
        has_alpha = "transparency" in img.info
        actual_c = 4 if has_alpha else 3
        img = img.convert("RGBA" if has_alpha else "RGB")
    if img.mode in ("I", "I;16", "F"):
        # 16/32-bit single channel: stb reduces to 8-bit before ldr_to_hdr.
        arr = np.asarray(img, dtype=np.float32)
        scale = 1.0 if img.mode == "F" else 257.0
        img = Image.fromarray(
            np.clip(arr / scale, 0, 255).astype(np.uint8), mode="L"
        )
    if img.mode != "RGBA":
        img = img.convert("RGBA")
    return _linearize(np.asarray(img), actual_c)


def decode_image(data: bytes) -> DecodedImage:
    """Decode an encoded image (PNG/JPEG/...) to stb-loadf-style f32 RGBA."""
    if data.startswith(PNG_SIGNATURE):
        return _decode_png(data)
    return _decode_pillow(data)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (h, w, 3) uint8 rows top-first, like stbi_write_png."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) uint8, got {rgb.shape} {rgb.dtype}")
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def encode_srgb_png_bytes(rgba_u8: np.ndarray) -> bytes:
    """Encode (h, w, c) uint8 to PNG bytes — used by procedural test scenes."""
    return encode_png(rgba_u8)
