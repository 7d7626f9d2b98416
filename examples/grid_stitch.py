"""Stitch a grid of images into one PNG or JPEG.

Usage: python examples/grid_stitch.py out.jpg a.png b.png c.jpg d.png
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from image_stitch_tpu import concat_to_file

if len(sys.argv) >= 3:
    out, *inputs = sys.argv[1:]
else:
    # Self-demo (no args): four noise tiles, stitched to /tmp.
    import numpy as np

    rng = np.random.default_rng(0)
    out = os.path.join(tempfile.gettempdir(), "grid_stitch_demo.jpg")
    inputs = [
        rng.integers(0, 256, (128, 128, 4), dtype=np.uint8) for _ in range(4)
    ]  # raw pixel arrays are first-class inputs
concat_to_file(
    {
        "inputs": inputs,
        "layout": {"columns": 2},
        "outputFormat": "jpeg" if out.endswith((".jpg", ".jpeg")) else "png",
        "jpegQuality": 90,
        "backgroundColor": "white",
        "onProgress": lambda done, total: print(f"  {done}/{total} inputs done"),
    },
    out,
)
print(f"wrote {out}")
