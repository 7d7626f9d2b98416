"""Native fused YCbCr+FDCT+quantize vs the shared numpy definition.

The C++ tier (native/stitchnative.cpp jpeg_quant_band_444, including the
16-bit two-block AVX2 path) must produce bit-identical quantized blocks to
ops/jpeg_dct.band_to_blocks_islow — that equality is the cross-tier JPEG
byte-identity contract (SURVEY §7 exactness invariants; reference being
replaced: the reference's Rust jpeg-encoder-wasm encode path).

Content is adversarial for the fixed-point range proof: full-range noise,
saturated checkerboards/stripes (maximal AC energy), and flat extremes.
Widths exercise both the paired-block fast path and the odd trailing
block.
"""

from __future__ import annotations

import numpy as np
import pytest

from image_stitch_tpu import native
from image_stitch_tpu.codecs.jpeg.tables import quality_scaled_tables
from image_stitch_tpu.ops.jpeg_dct import band_to_blocks_islow

pytestmark = pytest.mark.skipif(
    native.get_native_lib() is None, reason="native tier unavailable"
)


def _band(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    band = np.empty((h, w, 4), np.uint8)
    band[..., 3] = 255
    if kind == "noise":
        band[..., :3] = rng.integers(0, 256, (h, w, 3), np.uint8)
    elif kind == "checker":
        yy, xx = np.mgrid[0:h, 0:w]
        band[..., :3] = np.where(((yy + xx) & 1) == 0, 255, 0)[..., None]
    elif kind == "vstripes":
        band[..., :3] = (np.arange(w) & 1)[None, :, None] * 255
    elif kind == "hstripes":
        band[..., :3] = (np.arange(h) & 1)[:, None, None] * 255
    elif kind == "white":
        band[..., :3] = 255
    elif kind == "black":
        band[..., :3] = 0
    elif kind in ("red", "blue"):
        # Saturated chroma: ycbcr_int rounds the Cr/Cb sample up to 256,
        # so the level-shifted value is +128 and a flat block drives the
        # pass-2 DC sum to exactly +-2^15 (the int16 wraparound this
        # suite exists to catch — a red canvas once encoded as green).
        band[..., :3] = [255, 0, 0] if kind == "red" else [0, 0, 255]
    elif kind == "impulse":
        band[..., :3] = 0
        band[::8, ::8, :3] = 255
    else:  # gradient
        x = np.linspace(0, 255, w, dtype=np.float32)
        band[..., 0] = x[None, :].astype(np.uint8)
        band[..., 1] = np.linspace(0, 255, h, dtype=np.float32)[:, None].astype(np.uint8)
        band[..., 2] = 128
    return band


@pytest.mark.parametrize("kind", [
    "noise", "checker", "vstripes", "hstripes", "white", "black",
    "red", "blue", "impulse", "gradient",
])
@pytest.mark.parametrize("quality", [1, 50, 85, 100])
def test_native_quant_matches_numpy(kind: str, quality: int) -> None:
    lq, cq = quality_scaled_tables(quality)
    band = _band(kind, 16, 72)  # 9 blocks/strip: 4 pairs + odd trailing
    got = native.jpeg_quant_band_native(band, lq, cq)
    assert got is not None
    ref = band_to_blocks_islow(band, lq, cq, np)
    for g, r, name in zip(got, ref, "y cb cr".split()):
        np.testing.assert_array_equal(g, np.asarray(r, np.int16), err_msg=name)


@pytest.mark.parametrize("w", [8, 16, 24, 40, 136])
def test_native_quant_widths(w: int) -> None:
    lq, cq = quality_scaled_tables(85)
    band = _band("noise", 8, w, seed=w)
    got = native.jpeg_quant_band_native(band, lq, cq)
    assert got is not None
    ref = band_to_blocks_islow(band, lq, cq, np)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r, np.int16))


def test_native_quant_random_sweep() -> None:
    rng = np.random.default_rng(7)
    for trial in range(20):
        quality = int(rng.integers(1, 101))
        h = 8 * int(rng.integers(1, 4))
        w = 8 * int(rng.integers(1, 20))
        lq, cq = quality_scaled_tables(quality)
        band = _band("noise", h, w, seed=trial)
        got = native.jpeg_quant_band_native(band, lq, cq)
        assert got is not None
        ref = band_to_blocks_islow(band, lq, cq, np)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, np.asarray(r, np.int16))
