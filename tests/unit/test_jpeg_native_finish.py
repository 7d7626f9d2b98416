"""Native JPEG decode-finish tier vs the numpy oracle.

The C++ dequant+IDCT plane, fancy upsamplers, and fixed-point color
convert (native/stitchnative.cpp "jpeg decode finish" section) must be
bit-identical to codecs/jpeg/libjpeg_exact.py — same int64 ops, same
tables (passed in from the Python module). Reference analog: the
jpeg-js fallback tier (the reference's src/decoders/jpeg-decoder.ts),
which delegates decode math to the jpeg-js package.
"""

import io

import numpy as np
import pytest

from image_stitch_tpu.codecs.jpeg import libjpeg_exact as le
from image_stitch_tpu.native import (
    jpeg_fancy_upsample_native,
    jpeg_idct_plane_native,
    jpeg_ycc_rgb_native,
    native_available,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native tier unavailable"
)


def test_idct_plane_matches_numpy_full_range():
    rng = np.random.default_rng(3)
    for _ in range(8):
        by, bx = int(rng.integers(1, 9)), int(rng.integers(1, 9))
        blocks = rng.integers(-2048, 2048, (by * bx, 64)).astype(np.int32)
        q = rng.integers(1, 256, 64).astype(np.int32)
        got = jpeg_idct_plane_native(blocks, q, by, bx)
        coefs = (blocks.astype(np.int64) * q[None, :]).reshape(-1, 8, 8)
        pix = le.idct_islow_blocks(coefs)
        want = (
            pix.reshape(by, bx, 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(by * 8, bx * 8)
        )
        assert got is not None and np.array_equal(got, want)


def test_fancy_upsample_matches_numpy_all_shapes():
    rng = np.random.default_rng(5)
    for _ in range(30):
        h, w = int(rng.integers(1, 80)), int(rng.integers(1, 80))
        p = rng.integers(0, 256, (h, w), dtype=np.uint8)
        for (he, ve), ref in (
            ((2, 1), le.h2v1_fancy_upsample),
            ((2, 2), le.h2v2_fancy_upsample),
        ):
            got = jpeg_fancy_upsample_native(p, he, ve)
            assert got is not None and np.array_equal(got, ref(p))
    # Unsupported ratios fall back (caller uses replication/numpy).
    assert jpeg_fancy_upsample_native(p, 4, 1) is None


def test_ycc_rgb_matches_numpy_incl_strided_views():
    rng = np.random.default_rng(7)
    big = rng.integers(0, 256, (100, 100), dtype=np.uint8)
    y, cb, cr = big[:50, :60], big[10:60, 20:80], big[50:100, 40:100]
    got = jpeg_ycc_rgb_native(y, cb, cr)
    assert got is not None and np.array_equal(got, le.ycc_to_rgb(y, cb, cr))


def test_owned_decode_bit_identical_to_pil_all_samplings():
    """e2e: the native finish path must keep the owned decoder's libjpeg
    bit-identity contract (CLAUDE.md round-2 exactness facts)."""
    from PIL import Image

    import image_stitch_tpu.codecs.jpeg.owned_decoder as od

    rng = np.random.default_rng(11)
    x = np.linspace(0, 6, 131)
    base = (
        np.sin(x)[:, None] * np.cos(np.linspace(0, 5, 157))[None, :] * 80
        + 128
    )
    img = np.clip(
        np.stack(
            [base + rng.normal(0, 20, base.shape) for _ in range(3)], -1
        ),
        0,
        255,
    ).astype(np.uint8)
    for sub in (0, 1, 2):  # 444 / 422 / 420
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=87, subsampling=sub)
        own = od.decode_baseline_jpeg(buf.getvalue())
        pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        assert np.array_equal(own, pil)
    buf = io.BytesIO()
    Image.fromarray(img[:, :, 0]).save(buf, "JPEG", quality=87)
    own = od.decode_baseline_jpeg(buf.getvalue())
    pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("L"))
    assert np.array_equal(own[:, :, 0], pil)


def test_native_progressive_scan_matches_python_and_pil():
    """The C++ progressive scan decoder (DC/AC first + refinement, EOB
    runs) must match both the Python tier (coefficient arrays, scan by
    scan via the no-native env elsewhere) and PIL end to end. The 64-px
    444 case is the one that caught the br_fill shift-by-64 stale-bit
    desync (DC-refine scans drain the bit buffer to exactly 0)."""
    from PIL import Image

    import image_stitch_tpu.codecs.jpeg.owned_decoder as od

    rng = np.random.default_rng(5)
    x = np.linspace(0, 6, 64)
    base = (
        np.sin(x)[:, None] * np.cos(x)[None, :] * 80 + 128
    )
    img = np.clip(
        np.stack(
            [base + rng.normal(0, 18, base.shape) for _ in range(3)], -1
        ),
        0,
        255,
    ).astype(np.uint8)
    for sub in (0, 2):
        for shape in (img, img[:37, :53]):
            buf = io.BytesIO()
            Image.fromarray(shape).save(
                buf, "JPEG", quality=88, subsampling=sub, progressive=True
            )
            own = od.decode_baseline_jpeg(buf.getvalue())
            pil = np.asarray(
                Image.open(io.BytesIO(buf.getvalue())).convert("RGB")
            )
            assert np.array_equal(own, pil)
