"""Run configuration: config.json + CLI flags, reference key-compatible.

Mirrors the reference's two-source config (SURVEY.md C1/C2): quality knobs
from ``config.json`` — exactly the reference's keys ``grid_resolution``
(3-array), ``num_threads`` (nullable; host decode pool size here),
``num_samples``, ``max_bounce`` (src/main.zig:56-71, config.json:1-6) — and
per-run I/O via CLI flags ``--in/--out/--camera/--width/--height``
(src/main.zig:33-39).  Extras (wave_size, seed, progressive, backend, the
rendering extensions, debug_checks) are optional keys the reference never
had; unknown keys are rejected like Zig's std.json default
(src/main.zig:65) except the documented extras.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

REFERENCE_KEYS = {"grid_resolution", "num_threads", "num_samples", "max_bounce"}
EXTRA_INT_KEYS = {"wave_size", "seed", "progressive_every"}
EXTRA_STR_KEYS = {"backend"}
EXTRA_BOOL_KEYS = {"nee", "russian_roulette", "pbr", "debug_checks"}
EXTRA_KEYS = EXTRA_INT_KEYS | EXTRA_STR_KEYS | EXTRA_BOOL_KEYS


@dataclass
class Config:
    grid_resolution: tuple[int, int, int] = (128, 128, 128)
    # DOCUMENTED DIVERGENCE: in the reference ``num_threads`` sizes the
    # RENDER thread pool (src/main.zig:90, threads render pixel blocks,
    # src/stage3.zig:247-256).  Here the render runs on the device — there is
    # no render thread pool to size — so the knob keeps its only remaining
    # host-side meaning: the load-time image-decode pool
    # (src/stage1.zig:98-107; scene/gltf.py).  ``null`` still means
    # autodetect, like the reference.
    num_threads: int | None = None
    num_samples: int = 3
    max_bounce: int = 4
    # Extras the reference does not have:
    wave_size: int = 1 << 20  # rays in flight per jitted wave
    seed: int = 0
    progressive_every: int = 0  # waves between intermediate PNG dumps (0=off)
    backend: str = "auto"  # intersection: auto | mxu (baked bank) | grid
    # Extensions (render/extensions.py) — OFF by default: the reference has
    # none of these; enabling any changes the estimator (still converging to
    # the same image for nee/russian_roulette; pbr changes materials).
    nee: bool = False
    russian_roulette: bool = False
    pbr: bool = False
    # Debug mode (the analogue of the reference's Debug/ReleaseSafe
    # builds, build.zig:16, per SURVEY §5): enables jax_debug_nans for the
    # render and a non-finite radiance check on the framebuffer before PNG
    # encode (a NaN would otherwise clamp silently at gamma encode).
    debug_checks: bool = False

    @property
    def host_threads(self) -> int:
        return self.num_threads or os.cpu_count() or 1

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        unknown = set(raw) - REFERENCE_KEYS - EXTRA_KEYS
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        missing = REFERENCE_KEYS - set(raw)
        if missing:
            raise ValueError(f"missing config keys: {sorted(missing)}")
        gr = raw["grid_resolution"]
        if not (isinstance(gr, list) and len(gr) == 3):
            raise ValueError("grid_resolution must be a 3-array")
        cfg = cls(
            grid_resolution=tuple(int(x) for x in gr),
            num_threads=raw["num_threads"],
            num_samples=int(raw["num_samples"]),
            max_bounce=int(raw["max_bounce"]),
        )
        for key in EXTRA_INT_KEYS & set(raw):
            setattr(cfg, key, int(raw[key]))
        for key in EXTRA_STR_KEYS & set(raw):
            setattr(cfg, key, str(raw[key]))
        for key in EXTRA_BOOL_KEYS & set(raw):
            setattr(cfg, key, bool(raw[key]))
        return cfg

    @property
    def ext_flags(self):
        from .render.extensions import ExtFlags

        return ExtFlags(
            nee=self.nee, russian_roulette=self.russian_roulette, pbr=self.pbr
        )


@dataclass
class CmdlineArgs:
    """CLI surface of the reference binary (src/main.zig:33-39)."""

    in_path: str = "input.gltf"
    out_path: str = "output.png"
    camera: str | None = None
    width: int | None = None
    height: int | None = None
    config: str = "config.json"
    devices: str | None = field(default=None)  # extra: mesh size, e.g. "4"
