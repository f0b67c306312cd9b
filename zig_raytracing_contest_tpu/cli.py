"""Command-line entry point, flag-compatible with the reference binary.

Reference CLI (src/main.zig:33-39): ``--in`` (default input.gltf), ``--out``
(default output.png), ``--camera`` (name), ``--width``, ``--height``.
Extras: ``--config`` (path to config.json, default ./config.json like the
reference's install-side file) and ``--devices`` (device mesh size for
multi-device pixel-tile sharding; default: one device).

Run: ``python -m zig_raytracing_contest_tpu --in scene.gltf --out out.png``.
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zig_raytracing_contest_tpu",
        description="glTF path tracer on JAX (GPU or CPU)",
    )
    p.add_argument("--in", dest="in_path", default="input.gltf")
    p.add_argument("--out", dest="out_path", default="output.png")
    p.add_argument("--camera", default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--config", default="config.json")
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--log-level", default="INFO")
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="write a jax.profiler trace of the render to DIR (TensorBoard "
        "/ Perfetto format)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(levelname)s: %(message)s",
    )

    from .config import Config

    config = Config.load(args.config)

    profiler = None
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile, create_perfetto_trace=True)
        profiler = jax

    if args.devices is not None and args.devices > 1:
        from .parallel.sharding import render_file_sharded

        stats = render_file_sharded(
            args.in_path,
            args.out_path,
            config,
            camera_name=args.camera,
            width=args.width,
            height=args.height,
            num_devices=args.devices,
        )
    else:
        from .render.pipeline import render_file

        stats = render_file(
            args.in_path,
            args.out_path,
            config,
            camera_name=args.camera,
            width=args.width,
            height=args.height,
        )

    if profiler is not None:
        profiler.profiler.stop_trace()

    mrays = stats.segments / max(stats.phases.get("render", 1e-9), 1e-9) / 1e6
    logging.getLogger("zig_raytracing_contest_tpu").info(
        "Traced %d segments (%.2f Mrays/s)", stats.segments, mrays
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
