"""Command-line entry point: stitch images from the shell.

The reference is a library-only npm package; this CLI is a
convenience wrapper over the same public API (``concat_to_file``), so
every option maps 1:1 onto ``ConcatOptions``.

Examples:
    python -m image_stitch_tpu a.png b.png c.png d.png --columns 2 -o out.png
    python -m image_stitch_tpu tiles/*.png --columns 8 --format jpeg \\
        --quality 90 --threads 4 -o mosaic.jpg
    python -m image_stitch_tpu sprite.png --at 10,20 bg.png --at 0,0 \\
        --positioned -o composed.png
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="image_stitch_tpu",
        description="Stitch images into a grid or positioned composite "
        "(streaming, O(canvas-width) memory).",
    )
    p.add_argument("inputs", nargs="+", help="input image files (PNG/JPEG/HEIC)")
    p.add_argument("-o", "--output", required=True, help="output file path")
    p.add_argument("--columns", type=int, help="grid columns (row-major)")
    p.add_argument("--rows", type=int, help="grid rows (column-major)")
    p.add_argument(
        "--format", choices=["png", "jpeg"], default=None,
        help="output format (default: by output extension)",
    )
    p.add_argument("--quality", type=int, default=85, help="JPEG quality (1-100)")
    p.add_argument(
        "--sampling", choices=["444", "420"], default="444", help="JPEG subsampling"
    )
    p.add_argument(
        "--level", type=int, default=6, help="PNG compression level (0-9)"
    )
    p.add_argument(
        "--threads", type=int, default=0,
        help="host decode/deflate worker threads (0 = env/serial)",
    )
    p.add_argument(
        "--mesh", type=int, default=0,
        help="shard band programs over N accelerator devices",
    )
    p.add_argument(
        "--band-height", type=int, default=256, help="rows per streamed band"
    )
    p.add_argument(
        "--background", default=None,
        help="background color (name, #rgb/#rrggbb, or r,g,b[,a])",
    )
    p.add_argument(
        "--positioned", action="store_true",
        help="positioned mode: each input needs a matching --at x,y",
    )
    p.add_argument(
        "--at", action="append", default=[], metavar="X,Y",
        help="position for the Nth input (repeat per input; positioned mode)",
    )
    p.add_argument("--quiet", action="store_true", help="no progress output")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from . import PositionedImage, concat_to_file
    from .errors import StitchError

    out_format = args.format
    if out_format is None:
        lower = args.output.lower()
        out_format = "jpeg" if lower.endswith((".jpg", ".jpeg")) else "png"

    if args.positioned:
        if len(args.at) != len(args.inputs):
            print(
                f"error: --positioned needs one --at per input "
                f"({len(args.inputs)} inputs, {len(args.at)} --at)",
                file=sys.stderr,
            )
            return 2
        inputs = []
        for path, at in zip(args.inputs, args.at):
            try:
                x, y = (int(v) for v in at.split(","))
            except ValueError:
                print(f"error: bad --at value {at!r} (want X,Y)", file=sys.stderr)
                return 2
            inputs.append(PositionedImage(x=x, y=y, source=path))
        layout: dict = {}
    else:
        inputs = list(args.inputs)
        layout = {}
        if args.columns:
            layout["columns"] = args.columns
        if args.rows:
            layout["rows"] = args.rows
        if not layout:
            layout["columns"] = len(inputs)

    background = args.background
    if background and "," in background:
        background = tuple(int(v) for v in background.split(","))

    opts = {
        "inputs": inputs,
        "layout": layout,
        "outputFormat": out_format,
        "jpegQuality": args.quality,
        "jpegSampling": args.sampling,
        "pngCompressionLevel": args.level,
        "hostThreads": args.threads,
        "bandHeight": args.band_height,
    }
    if background is not None:
        opts["backgroundColor"] = background
    if args.mesh:
        opts["mesh"] = args.mesh
    if not args.quiet:
        opts["onProgress"] = lambda done, total: print(
            f"\r{done}/{total} inputs", end="" if done < total else "\n",
            file=sys.stderr,
        )
    try:
        concat_to_file(opts, args.output)
    except StitchError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
