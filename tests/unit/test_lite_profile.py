"""Minimal-profile import graph — the browser-bundle analog.

The reference ships a tree-shaken browser bundle (src/bundle.ts, 49.6 KB
IIFE) whose point is: the PNG-only path carries no optional decoder weight.
The Python-native equivalent contract: importing the package and running a
PNG-only concat must not pull the accelerator stack (jax) or optional
decode tiers (PIL, pillow-heif) — they load lazily on first use.

jax may already be loaded in the interpreter, so the test evicts it first
and asserts the package never re-imports it.
"""

import subprocess
import sys


def _run_isolated(code: str) -> None:
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


EVICT = """
import sys
for m in list(sys.modules):
    if m == "jax" or m.startswith(("jax.", "jaxlib", "PIL", "flax", "torch")):
        del sys.modules[m]
"""


def test_package_import_does_not_pull_jax_or_pil():
    _run_isolated(
        EVICT
        + """
import image_stitch_tpu
heavy = [m for m in sys.modules
         if m == "jax" or m.startswith(("jax.", "jaxlib", "PIL.", "torch"))]
assert not heavy, f"package import pulled heavy deps: {heavy}"
"""
    )


def test_png_only_concat_stays_lite():
    """The full PNG decode -> composite -> PNG encode path on the host
    backend runs without jax or PIL ever loading."""
    _run_isolated(
        EVICT
        + """
import io, zlib
import numpy as np
from image_stitch_tpu import PngHeader, build_png, concat_to_buffer
from image_stitch_tpu.ops.png_filter import filter_select_band

arr = np.full((16, 64), 7, np.uint8)
t, f = filter_select_band(arr, None, 4)
p = np.empty((16, 65), np.uint8); p[:, 0] = t; p[:, 1:] = f
png = build_png(PngHeader(width=16, height=16, bit_depth=8, color_type=6),
                zlib.compress(p.tobytes()))
out = concat_to_buffer({"inputs": [png, png], "layout": {"columns": 2},
                        "backend": "numpy"})
assert out[:4] == b"\\x89PNG"[:4]
heavy = [m for m in sys.modules
         if m == "jax" or m.startswith(("jax.", "jaxlib", "PIL.", "torch"))]
assert not heavy, f"PNG-only concat pulled heavy deps: {heavy}"
"""
    )


def test_jpeg_output_loads_jax_only_when_device_backend():
    _run_isolated(
        EVICT
        + """
import zlib
import numpy as np
from image_stitch_tpu import PngHeader, build_png, concat_to_buffer
from image_stitch_tpu.ops.png_filter import filter_select_band

arr = np.full((16, 64), 7, np.uint8)
t, f = filter_select_band(arr, None, 4)
p = np.empty((16, 65), np.uint8); p[:, 0] = t; p[:, 1:] = f
png = build_png(PngHeader(width=16, height=16, bit_depth=8, color_type=6),
                zlib.compress(p.tobytes()))
out = concat_to_buffer({"inputs": [png], "layout": {"columns": 1},
                        "backend": "numpy", "outputFormat": "jpeg"})
assert out[:2] == b"\\xff\\xd8"
assert "jax" not in sys.modules, "host JPEG encode must not load jax"
"""
    )


def test_migration_guide_names_all_exist():
    """docs/MIGRATION.md maps every reference export to a name here; keep
    the guide honest by asserting each mapped name is importable."""
    import re

    import image_stitch_tpu as ist

    guide = open("docs/MIGRATION.md").read()
    # Backticked snake_case/CamelCase identifiers in the "Here" prose that
    # look like package attributes (skip option keys, env vars, files).
    names = set(re.findall(r"`([a-z_]+[a-z0-9_]*|[A-Z][A-Za-z0-9]+)\(?\)?`", guide))
    skip = {
        # option keys / env / commands / non-attribute identifiers
        "inputs", "layout", "columns", "rows", "width", "height", "decoders",
        "decoderOptions", "decoder_options", "outputFormat", "jpegQuality",
        "backgroundColor", "background_color", "output_format", "jpeg_quality",
        "enableAlphaBlending", "onProgress", "plugins", "band_height",
        "backend", "mesh", "host_threads", "jpeg_restart_interval_rows",
        "max_canvas_dim", "jpeg_sampling", "custom_decoders", "bytes",
        "snake_case", "camelCase", "image_stitch_tpu", "types",
        # reference-side type/interface names quoted in the left column
        # (documented as folded into DecoderOptions / the decoder protocol)
        "ImageDecoder", "ImageFormat", "ImageInput", "JpegDecoderOptions",
        "HeicDecoderOptions", "Blob", "Readable",
    }
    methods = {
        # decoder/encoder/concatenator METHOD names, not package attributes
        "get_header_info", "stream", "header", "encode_strip", "finish",
        "get_header", "bands", "scanlines", "close", "write", "pull",
    }
    ts_names = {n for n in names if any(c.isupper() for c in n[1:]) and
                n[0].islower()}  # reference camelCase exports
    candidates = names - skip - methods - ts_names
    missing = sorted(n for n in candidates if not hasattr(ist, n))
    assert missing == [], f"MIGRATION.md references missing names: {missing}"
