"""Compute backends for the band pipeline.

The orchestrator is backend-agnostic: ``numpy`` (the host oracle — float64
semantics identical to the reference's JS) and ``jax`` (device compute:
vectorized filter selection and JPEG DCT/quantization on the accelerator
via XLA; see :mod:`image_stitch_tpu.ops.device`).

Both backends are bit-exact for everything the reference's grid mode does
(pure integer math); see ops/device.py for the alpha-blend exactness notes.
"""

from __future__ import annotations

import numpy as np

from .pixel import band_to_bytes
from .png_filter import filter_select_band


class NumpyBackend:
    """Host-side oracle backend. The async API is the sync one (compute on
    submit, identity on wait) so the orchestrator has one pipeline shape."""

    name = "numpy"

    def png_filter_band(
        self, canvas: np.ndarray, prev_row: np.ndarray | None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Filter-select a canvas band.

        ``canvas``: (H, W, 4) uint8/uint16. ``prev_row``: previous *raw* row
        bytes (W*bpp,) or None. Returns (filter_types (H,), filtered rows
        (H, W*bpp), last raw row (W*bpp,)) — the carry for the next band.
        """
        bpp = 8 if canvas.dtype == np.uint16 else 4
        raw = band_to_bytes(canvas)
        from ..native import filter_select_band_native

        native = filter_select_band_native(raw, prev_row, bpp)
        if native is not None:
            types, filtered = native
        else:
            types, filtered = filter_select_band(raw, prev_row, bpp)
        return types, filtered, raw[-1]

    def png_filter_band_async(self, canvas, prev_row):
        return self.png_filter_band(canvas, prev_row)

    @staticmethod
    def png_filter_band_wait(pending):
        return pending


_BACKENDS: dict[str, object] = {}

# Option names -> concrete backends. 'auto' is the host tier: on an H100 the
# device path won end to end at no canvas size measured (0.26-67 MP, PNG and
# JPEG output; PERF.md), so the device runs only when named ('jax', or its
# alias 'tpu') or through a mesh.
_ALIASES = {"oracle": "numpy", "auto": "numpy", "tpu": "jax"}


def resolve_backend_name(name: str) -> str:
    """Map an option string to a concrete backend: 'numpy' or 'jax'."""
    return _ALIASES.get(name, name)


def get_backend(name: str):
    """'oracle'/'numpy'/'auto' -> NumpyBackend; 'jax'/'tpu' -> JaxBackend."""
    key = resolve_backend_name(name)
    if key not in _BACKENDS:
        if key == "numpy":
            _BACKENDS[key] = NumpyBackend()
        elif key == "jax":
            from .device import JaxBackend

            _BACKENDS[key] = JaxBackend()
        else:
            raise ValueError(f"Unknown backend: {name}")
    return _BACKENDS[key]
