"""Free-form composite: background + sprites with z-order and alpha.

Usage: python examples/positioned_composite.py out.png bg.png sprite.png
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from image_stitch_tpu import PositionedImage, concat_to_file

if len(sys.argv) >= 4:
    out, bg, sprite = sys.argv[1:4]
else:
    # Self-demo (no args): solid background + semi-transparent sprite.
    import numpy as np

    out = os.path.join(tempfile.gettempdir(), "positioned_demo.png")
    bg = np.full((180, 240, 4), (30, 60, 120, 255), dtype=np.uint8)
    sprite = np.full((64, 64, 4), (250, 200, 40, 160), dtype=np.uint8)
concat_to_file(
    {
        "inputs": [
            PositionedImage(x=0, y=0, source=bg),
            PositionedImage(x=40, y=30, source=sprite, z_index=10),
            PositionedImage(x=80, y=60, source=sprite, z_index=5),
        ],
        "layout": {},  # canvas auto-sized to max(x+w), max(y+h)
        "enableAlphaBlending": True,
    },
    out,
)
print(f"wrote {out}")
