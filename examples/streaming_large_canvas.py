"""Stream an arbitrarily tall canvas with O(width) memory: lazy tile
factories + band streaming + live telemetry.

Usage: python examples/streaming_large_canvas.py out.png
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import zlib

import numpy as np

from image_stitch_tpu import (
    CoreStreamingConcatenator,
    ImageSource,
    PngHeader,
    build_png,
)


def make_tile(i: int):
    def factory():
        rng = np.random.default_rng(i)
        arr = rng.integers(0, 256, (512, 512, 4), dtype=np.uint8)
        arr[:, :, 3] = 255
        raw = np.concatenate(
            [np.zeros((512, 1), np.uint8), arr.reshape(512, 512 * 4)], axis=1
        )  # filter-type-0 scanlines
        return build_png(
            PngHeader(width=512, height=512, bit_depth=8, color_type=6),
            zlib.compress(raw.tobytes(), 1),
        )

    return ImageSource(width=512, height=512, factory=factory, format="png")


out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(tempfile.gettempdir(), "streaming_demo.png")
core = CoreStreamingConcatenator(
    {
        "inputs": [make_tile(i) for i in range(64)],  # 4 x 16 grid, 2048x8192
        "layout": {"columns": 4},
        "band_height": 256,
        "png_compression_level": 1,
        "png_compression_strategy": "rle",
    }
)
with open(out, "wb") as f:
    for chunk in core.stream():
        f.write(chunk)
print("stats:", core.stats.report())
print("streaming efficiency ok:", core.stats.check_streaming_efficiency())
