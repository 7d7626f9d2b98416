"""Device JPEG decode compute (ops/jpeg_idct_device) vs the int64 host
oracle (codecs/jpeg/libjpeg_exact): the two-limb int32 IDCT, the upsample
ports, the arithmetic color convert, and the fused band trace must be
bit-identical for every input within the documented M_SAFE bound."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from image_stitch_tpu.codecs.jpeg import libjpeg_exact as oracle
from image_stitch_tpu.ops import jpeg_idct_device as dev


def _oracle_idct(coefq: np.ndarray) -> np.ndarray:
    return oracle.idct_islow_blocks(coefq.astype(np.int64))


def test_pass_matrices_match_butterflies():
    """The derived weight matrices ARE the butterfly maps: random int64
    blocks produce identical pre-clamp outputs through both forms."""
    rng = np.random.default_rng(0)
    blk = rng.integers(-(1 << 19), 1 << 19, (64, 8, 8)).astype(np.int64)
    ws_ref = oracle._islow_pass1(blk)
    ws_mat = oracle._descale(
        np.einsum("rk,nkc->nrc", dev._W1, blk),
        oracle.CONST_BITS - oracle.PASS1_BITS,
    )
    np.testing.assert_array_equal(ws_ref, ws_mat)
    out_ref = oracle._islow_pass2(ws_ref)
    out_mat = oracle._descale(
        np.einsum("ck,nrk->nrc", dev._W2, ws_ref),
        oracle.CONST_BITS + oracle.PASS1_BITS + 3,
    )
    np.testing.assert_array_equal(out_ref, out_mat)


@pytest.mark.parametrize("xp_name", ["numpy", "jnp"])
def test_idct_exact_random_legal_range(xp_name):
    xp = np if xp_name == "numpy" else jnp
    rng = np.random.default_rng(1)
    # Legal baseline dequantized range: |coef| <= 2047, q <= 255.
    coefq = (
        rng.integers(-2047, 2048, (256, 8, 8))
        * rng.integers(1, 256, (256, 1, 1))
    ).astype(np.int32)
    assert np.abs(coefq).max() <= dev.M_SAFE
    got = dev.idct_islow_exact(xp.asarray(coefq), xp)
    np.testing.assert_array_equal(np.asarray(got), _oracle_idct(coefq))


@pytest.mark.parametrize("xp_name", ["numpy", "jnp"])
def test_idct_exact_at_bound(xp_name):
    """Adversarial blocks at exactly +-M_SAFE (including same-sign all-max,
    alternating, sparse single-coefficient) — the documented safe bound
    must hold, not just typical content."""
    xp = np if xp_name == "numpy" else jnp
    m = dev.M_SAFE
    blocks = [
        np.full((8, 8), m, np.int32),
        np.full((8, 8), -m, np.int32),
        np.fromfunction(lambda r, c: ((r + c) % 2 * 2 - 1) * m, (8, 8)).astype(
            np.int32
        ),
    ]
    for r in range(8):
        for c in range(8):
            b = np.zeros((8, 8), np.int32)
            b[r, c] = m
            blocks.append(b)
            blocks.append(-b)
    rng = np.random.default_rng(2)
    blocks.append(rng.integers(-m, m + 1, (8, 8)).astype(np.int32))
    coefq = np.stack(blocks)
    got = dev.idct_islow_exact(xp.asarray(coefq), xp)
    np.testing.assert_array_equal(np.asarray(got), _oracle_idct(coefq))


def _to_t(coefq: np.ndarray) -> np.ndarray:
    """(N, 8, 8) -> (8, 8, N) transposed layout."""
    return np.transpose(coefq, (1, 2, 0))


@pytest.mark.parametrize("xp_name", ["numpy", "jnp"])
def test_butterfly_idct_exact_random_legal_range(xp_name):
    xp = np if xp_name == "numpy" else jnp
    rng = np.random.default_rng(11)
    coefq = (
        rng.integers(-2047, 2048, (256, 8, 8))
        * rng.integers(1, 256, (256, 1, 1))
    ).astype(np.int32)
    got = dev.idct_islow_exact_t(xp.asarray(_to_t(coefq)), xp)
    np.testing.assert_array_equal(
        np.asarray(got), _to_t(_oracle_idct(coefq))
    )


@pytest.mark.parametrize("xp_name", ["numpy", "jnp"])
def test_butterfly_idct_exact_at_bound(xp_name):
    """Adversarial blocks at exactly +-M_SAFE through the butterfly form
    (the machine-checked interval bound must hold at its own edge)."""
    xp = np if xp_name == "numpy" else jnp
    m = dev.M_SAFE
    blocks = [
        np.full((8, 8), m, np.int32),
        np.full((8, 8), -m, np.int32),
        np.fromfunction(lambda r, c: ((r + c) % 2 * 2 - 1) * m, (8, 8)).astype(
            np.int32
        ),
    ]
    for r in range(8):
        for c in range(8):
            b = np.zeros((8, 8), np.int32)
            b[r, c] = m
            blocks.append(b)
            blocks.append(-b)
    rng = np.random.default_rng(12)
    blocks.append(rng.integers(-m, m + 1, (8, 8)).astype(np.int32))
    coefq = np.stack(blocks)
    got = dev.idct_islow_exact_t(xp.asarray(_to_t(coefq)), xp)
    np.testing.assert_array_equal(
        np.asarray(got), _to_t(_oracle_idct(coefq))
    )


def test_butterfly_bound_covers_published_m_safe():
    """The interval proof must hold at (and the published bound never
    exceed) the butterfly's machine-checked maximum."""
    assert dev._butterfly_fits(dev.M_SAFE)
    assert dev.M_SAFE <= dev._BF_M_MAX
    assert not dev._butterfly_fits(dev._BF_M_MAX + 1)


@pytest.mark.parametrize("k", [1, 5, 32, 64])
def test_dezigzag_pad_t_matches_row_form(k):
    rng = np.random.default_rng(13)
    zz = rng.integers(-2047, 2048, (37, k)).astype(np.int32)
    ref = dev.dezigzag_pad(zz, k, np)
    got = dev.dezigzag_pad_t(zz, k, np)
    np.testing.assert_array_equal(got, ref.T)
    got_j = dev.dezigzag_pad_t(jnp.asarray(zz), k, jnp)
    np.testing.assert_array_equal(np.asarray(got_j), ref.T)


@pytest.mark.parametrize("by,bx", [(1, 1), (4, 7), (3, 128)])
def test_assemble_plane_matches_block_layout(by, bx):
    """plane[8i + r, 8j + c] == pix[r, c, i*bx + j], jitted and eager."""
    rng = np.random.default_rng(7)
    pix = rng.integers(0, 256, (8, 8, by * bx), dtype=np.uint8)
    ref = np.empty((by * 8, bx * 8), np.uint8)
    for i in range(by):
        for j in range(bx):
            ref[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = pix[:, :, i * bx + j]
    got = dev._assemble_plane_t(jnp.asarray(pix), by, bx, jnp)
    assert got.dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(got), ref)
    got_jit = jax.jit(
        lambda p: dev._assemble_plane_t(p, by, bx, jnp)
    )(jnp.asarray(pix))
    np.testing.assert_array_equal(np.asarray(got_jit), ref)


def test_idct_exact_under_jit():
    rng = np.random.default_rng(3)
    coefq = rng.integers(-500_000, 500_001, (128, 8, 8)).astype(np.int32)
    got = jax.jit(lambda x: dev.idct_islow_exact(x, jnp))(jnp.asarray(coefq))
    np.testing.assert_array_equal(np.asarray(got), _oracle_idct(coefq))


def test_upsample_ports_exact():
    rng = np.random.default_rng(4)
    for h, w in [(8, 8), (16, 24), (3, 5), (1, 4), (7, 3)]:
        plane = rng.integers(0, 256, (h, w), dtype=np.uint8)
        for h_exp, v_exp in [(1, 1), (2, 1), (2, 2), (1, 2), (4, 2)]:
            ref = oracle.upsample_plane(plane, h_exp, v_exp)
            got_np = dev.upsample_plane_x(plane, h_exp, v_exp, np)
            np.testing.assert_array_equal(
                np.asarray(got_np).astype(np.uint8), ref,
                err_msg=f"np {h}x{w} x{h_exp}x{v_exp}",
            )
            got_j = dev.upsample_plane_x(jnp.asarray(plane), h_exp, v_exp, jnp)
            np.testing.assert_array_equal(
                np.asarray(got_j).astype(np.uint8), ref,
                err_msg=f"jnp {h}x{w} x{h_exp}x{v_exp}",
            )


def test_color_convert_exact_exhaustive_axes():
    """All 256 values per channel axis (y, cb, cr swept against mid-range
    others) plus dense random — equals the host table-driven convert."""
    rng = np.random.default_rng(5)
    sweep = np.arange(256, dtype=np.uint8)
    mid = np.full(256, 128, np.uint8)
    cases = [
        (sweep, mid, mid),
        (mid, sweep, mid),
        (mid, mid, sweep),
        tuple(rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)),
    ]
    for y, cb, cr in cases:
        ref = oracle.ycc_to_rgb(y, cb, cr)
        got = dev.ycc_to_rgb_x(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jnp)
        np.testing.assert_array_equal(np.asarray(got), ref)


def _encode_jpeg_pil(arr: np.ndarray, quality: int, sampling: str) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(
        buf, "JPEG", quality=quality,
        subsampling={"444": 0, "422": 1, "420": 2}[sampling],
    )
    return buf.getvalue()


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_decode_rgb_trace_matches_owned_decoder(sampling):
    """Fused device decode trace == the owned host decoder's pixels (which
    are PIL/libjpeg bit-identical by the round-4 contract) on real encoded
    streams at every sampling, including non-MCU-aligned edges."""
    from image_stitch_tpu.codecs.jpeg.owned_decoder import (
        decode_baseline_jpeg,
        decode_coefficients,
    )

    rng = np.random.default_rng(6)
    x = np.linspace(0, 255, 67, dtype=np.float32)
    arr = np.empty((45, 67, 3), np.uint8)
    arr[..., 0] = x[None, :].astype(np.uint8)
    arr[..., 1] = rng.integers(0, 256, (45, 67), dtype=np.uint8)
    arr[..., 2] = x[None, ::-1].astype(np.uint8)
    data = _encode_jpeg_pil(arr, 85, sampling)

    ref = decode_baseline_jpeg(data)
    comps, qtabs, geom, width, height = decode_coefficients(data)
    k = 64
    zz = [c[:, np.asarray(dev.ZIGZAG)] for c in comps]
    got = dev.decode_rgb_trace(
        [jnp.asarray(z[:, :k].astype(np.int32)) for z in zz],
        [jnp.asarray(q) for q in qtabs],
        geom, k, width, height, jnp,
    )
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_decode_rgb_trace_gray():
    from image_stitch_tpu.codecs.jpeg.owned_decoder import (
        decode_baseline_jpeg,
        decode_coefficients,
    )
    import io

    from PIL import Image

    rng = np.random.default_rng(7)
    g = rng.integers(0, 256, (21, 33), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(g, mode="L").save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    ref = decode_baseline_jpeg(data)
    comps, qtabs, geom, width, height = decode_coefficients(data)
    zz = [c[:, np.asarray(dev.ZIGZAG)] for c in comps]
    got = dev.decode_rgb_trace(
        [jnp.asarray(z.astype(np.int32)) for z in zz],
        [jnp.asarray(q) for q in qtabs],
        geom, 64, width, height, jnp,
    )
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_ycbcr_int_packed_matches_interleaved():
    """The encoder-side packed ingest (ycbcr_int on (H, W) uint32 bands)
    must equal the interleaved form channel for channel."""
    from image_stitch_tpu.ops.jpeg_dct import ycbcr_int

    rng = np.random.default_rng(21)
    rgba = rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    packed = rgba.view(np.uint32).reshape(24, 40)
    for xp in (np, jnp):
        ref = ycbcr_int(xp.asarray(rgba), xp)
        got = ycbcr_int(xp.asarray(packed), xp)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("gray", [False, True])
def test_decode_band_trace_packed_is_bitcast_of_rgba(gray):
    """_decode_band_trace(packed=True) must be the exact little-endian
    uint32 pack of the RGBA output (same bytes, no relayout drift)."""
    from image_stitch_tpu.codecs.jpeg.device_decoder import DeviceJpegDecoder
    import io

    from PIL import Image

    rng = np.random.default_rng(22)
    if gray:
        arr = rng.integers(0, 256, (40, 56), dtype=np.uint8)
        img = Image.fromarray(arr, mode="L")
    else:
        arr = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        img = Image.fromarray(arr)
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=85)
    dec = DeviceJpegDecoder(buf.getvalue())
    rgba = dec.decode_band(0, 40)
    packed_host = dec.decode_band(0, 40, packed=True)
    np.testing.assert_array_equal(packed_host, rgba)
    packed_dev = np.asarray(dec.decode_band(0, 40, return_device=True,
                                            packed=True))
    np.testing.assert_array_equal(
        packed_dev.view(np.uint8).reshape(40, dec.width, 4), rgba
    )
