"""The numpy + zlib PNG codec (utils/image_io.py) against Pillow.

``decode_image`` must give what the Pillow-based decoder gives — the same
f32 RGBA texels and the same ``actual_c`` — for every PNG kind a glTF
texture can be, and the renderer must write its PNG with Pillow absent.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from zig_raytracing_contest_tpu.utils import image_io

RNG = np.random.default_rng(0)
ROOT = Path(__file__).resolve().parent.parent


def _pillow_png(arr, mode, **save):
    buf = io.BytesIO()
    img = Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode)
    img.save(buf, format="PNG", **save)
    return buf.getvalue()


def _pixels(shape):
    """Noise with flat and gradient rows, so Pillow's adaptive filtering
    picks several of the five filter types."""
    a = RNG.integers(0, 256, shape, dtype=np.uint8)
    a[: shape[0] // 4] = 7
    a[shape[0] // 4 : shape[0] // 2] = np.arange(shape[1], dtype=np.uint8)[
        None, :, *([None] if len(shape) == 3 else [])
    ]
    return a


def _palette(transparency):
    img = Image.fromarray(_pixels((20, 30, 3))).convert(
        "P", palette=Image.ADAPTIVE, colors=16
    )
    buf = io.BytesIO()
    kw = {} if transparency is None else {"transparency": transparency}
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


CASES = {
    "grey8": lambda: _pillow_png(_pixels((17, 23)), "L"),
    "grey_alpha8": lambda: _pillow_png(_pixels((17, 23, 2)), "LA"),
    "rgb8": lambda: _pillow_png(_pixels((33, 48, 3)), "RGB"),
    "rgba8": lambda: _pillow_png(_pixels((31, 29, 4)), "RGBA"),
    "rgba8_optimized": lambda: _pillow_png(_pixels((64, 64, 4)), "RGBA",
                                           optimize=True),
    "palette": lambda: _palette(None),
    "palette_trns": lambda: _palette(3),
    # 16-bit grey holding 257·k: stb's high byte and Pillow's /257 agree.
    "grey16": lambda: _pillow_png(
        (RNG.integers(0, 256, (9, 11)) * 257).astype(np.uint16), None
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_pillow(name):
    data = CASES[name]()
    ours = image_io.decode_image(data)
    ref = image_io._decode_pillow(data)
    assert (ours.width, ours.height, ours.actual_c) == (
        ref.width, ref.height, ref.actual_c
    )
    np.testing.assert_array_equal(ours.pixels, ref.pixels)


@pytest.mark.parametrize("filter_type", range(5))
def test_each_filter_type(filter_type):
    """A hand-filtered RGB image per filter type decodes exactly."""
    import zlib

    h, w, bpp = 6, 5, 3
    img = RNG.integers(0, 256, (h, w * bpp)).astype(np.int64)
    raw = []
    prev = np.zeros(w * bpp, np.int64)
    for row in img:
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][filter_type]
        raw.append(np.concatenate([[filter_type], (row - pred) % 256]))
        prev = row
    body = zlib.compress(np.asarray(raw, np.uint8).tobytes())
    import struct

    data = (
        image_io.PNG_SIGNATURE
        + image_io._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                   0, 0, 0))
        + image_io._png_chunk(b"IDAT", body)
        + image_io._png_chunk(b"IEND", b"")
    )
    out = image_io.read_png(data)
    np.testing.assert_array_equal(out.reshape(h, w * bpp), img.astype(np.uint8))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_round_trip(channels):
    px = RNG.integers(0, 256, (13, 21, channels), dtype=np.uint8)
    data = image_io.encode_png(px)
    got = image_io.read_png(data)
    np.testing.assert_array_equal(got.reshape(px.shape), px)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))).reshape(px.shape), px
    )


def test_write_png_read_by_pillow(tmp_path):
    rgb = RNG.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    image_io.write_png(str(tmp_path / "o.png"), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "o.png")),
                                  rgb)


def test_interlaced_png_rejected():
    import struct
    import zlib

    data = (
        image_io.PNG_SIGNATURE
        + image_io._png_chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2,
                                                   0, 0, 1))
        + image_io._png_chunk(b"IDAT", zlib.compress(bytes(64)))
        + image_io._png_chunk(b"IEND", b"")
    )
    with pytest.raises(ValueError, match="interlaced"):
        image_io.decode_image(data)


def test_render_writes_png_without_pillow(tmp_path):
    """The CLI path (glTF with PNG textures in, PNG out) runs with Pillow
    unimportable."""
    from zig_raytracing_contest_tpu.scene import procedural

    scene = procedural.cornell_like_box(tmp_path / "s.glb", glb=True)
    cfg = tmp_path / "config.json"
    cfg.write_text('{"grid_resolution": [8, 8, 8], "num_threads": null, '
                   '"num_samples": 1, "max_bounce": 2}')
    out = tmp_path / "out.png"
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from zig_raytracing_contest_tpu.cli import main\n"
        f"sys.exit(main(['--in', {str(scene)!r}, '--out', {str(out)!r},"
        f" '--camera', 'Camera 1', '--width', '16', '--height', '16',"
        f" '--config', {str(cfg)!r}]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert image_io.read_png(out.read_bytes()).shape == (16, 16, 3)


def test_non_png_without_pillow_names_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        image_io.decode_image(b"\xff\xd8\xff\xe0 not really a jpeg")
