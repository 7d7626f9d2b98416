"""Owned JPEG decoder tests: cross-checked against PIL on both our own
encoder's output and PIL-encoded files (420/444, restart intervals)."""

import io

import numpy as np
import pytest

from image_stitch_tpu.codecs.jpeg.owned_decoder import decode_baseline_jpeg
from image_stitch_tpu.errors import StitchError


def smooth(w, h, seed=0):
    x = np.linspace(0, 230, w, dtype=np.float32)
    y = np.linspace(20, 250, h, dtype=np.float32)
    arr = np.zeros((h, w, 3), np.uint8)
    arr[:, :, 0] = x[None, :].astype(np.uint8)
    arr[:, :, 1] = y[:, None].astype(np.uint8)
    arr[:, :, 2] = ((x[None, :] + y[:, None]) / 2).astype(np.uint8)
    return arr


def pil_jpeg(arr, **kwargs):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


def pil_decode(data):
    from PIL import Image

    return np.array(Image.open(io.BytesIO(data)).convert("RGB")).astype(int)


@pytest.mark.parametrize("sampling", [0, 1, 2])  # 444, 422, 420 in PIL terms
def test_decode_pil_encoded(sampling):
    arr = smooth(67, 45, sampling)
    data = pil_jpeg(arr, quality=90, subsampling=sampling)
    ours = decode_baseline_jpeg(data).astype(int)
    theirs = pil_decode(data)
    assert ours.shape == theirs.shape
    # IDCT/upsample implementations differ slightly; stay within a few LSBs.
    assert np.abs(ours - theirs).mean() < 2.0
    assert np.abs(ours - theirs).max() <= 16


def test_decode_own_encoder_output():
    from image_stitch_tpu.codecs.jpeg.encoder import encode_jpeg

    arr4 = np.dstack([smooth(64, 48), np.full((48, 64), 255, np.uint8)])
    data = encode_jpeg(arr4, 64, 48, quality=92)
    ours = decode_baseline_jpeg(data).astype(int)
    theirs = pil_decode(data)
    assert np.abs(ours - theirs).max() <= 4


def test_decode_with_restart_intervals():
    arr = smooth(96, 64, 3)
    data = pil_jpeg(arr, quality=85, restart_marker_blocks=2)
    if b"\xff\xdd" not in data:
        pytest.skip("PIL did not emit DRI")
    ours = decode_baseline_jpeg(data).astype(int)
    theirs = pil_decode(data)
    assert np.abs(ours - theirs).mean() < 2.0


def test_grayscale_jpeg():
    from PIL import Image

    buf = io.BytesIO()
    g = np.linspace(0, 255, 32 * 24, dtype=np.uint8).reshape(24, 32)
    Image.fromarray(g, "L").save(buf, format="JPEG", quality=95)
    ours = decode_baseline_jpeg(buf.getvalue())
    assert ours.shape == (24, 32, 3)
    assert np.abs(ours[:, :, 0].astype(int) - g.astype(int)).mean() < 3


def noisy(w, h, seed=0):
    rng = np.random.default_rng(seed)
    arr = smooth(w, h).astype(np.int16)
    return (arr + rng.integers(-15, 16, arr.shape)).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("sampling", [0, 1, 2])
def test_progressive_decodes_bit_identical_to_pil(sampling):
    """Progressive DCT (SOF2, spectral selection + successive approximation)
    must decode bit-identically to PIL/libjpeg — the owned tier is a full
    drop-in (reference jpeg-decoder.ts:250-262)."""
    arr = noisy(67, 45, sampling)
    data = pil_jpeg(arr, quality=85, progressive=True, subsampling=sampling)
    assert b"\xff\xc2" in data  # really SOF2
    np.testing.assert_array_equal(decode_baseline_jpeg(data), pil_decode(data))


def test_progressive_odd_dims_bit_identical():
    arr = noisy(33, 17, 9)
    data = pil_jpeg(arr, quality=85, progressive=True, subsampling=2)
    np.testing.assert_array_equal(decode_baseline_jpeg(data), pil_decode(data))


def test_progressive_grayscale_bit_identical():
    from PIL import Image

    rng = np.random.default_rng(4)
    g = rng.integers(0, 256, (50, 70), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(g, "L").save(buf, "JPEG", quality=80, progressive=True)
    np.testing.assert_array_equal(
        decode_baseline_jpeg(buf.getvalue()), pil_decode(buf.getvalue())
    )


def test_baseline_noisy_bit_identical_to_pil():
    """The islow-IDCT + fancy-upsample + fixed-point color path matches
    libjpeg exactly even on high-entropy images (the float-IDCT path was
    only approximately equal)."""
    for sub in (0, 1, 2):
        arr = noisy(64, 48, sub)
        data = pil_jpeg(arr, quality=85, subsampling=sub)
        np.testing.assert_array_equal(decode_baseline_jpeg(data), pil_decode(data))


def test_lossless_sof_rejected_with_clear_error():
    """Unsupported SOF classes still fail clearly (SOF3 lossless)."""
    arr = smooth(32, 32)
    data = bytearray(pil_jpeg(arr, quality=85))
    i = data.find(b"\xff\xc0")
    data[i + 1] = 0xC3
    with pytest.raises(StitchError, match="lossless|baseline"):
        decode_baseline_jpeg(bytes(data))


def test_invalid_data_rejected():
    with pytest.raises(StitchError):
        decode_baseline_jpeg(b"\x00\x01\x02")
    with pytest.raises(StitchError):
        decode_baseline_jpeg(b"\xff\xd8\xff\xd9")  # SOI+EOI, no SOF/SOS


def test_force_owned_tier_through_decoder():
    from image_stitch_tpu.codecs.jpeg.decoder import JpegDecoder
    from image_stitch_tpu.types import DecoderOptions

    arr = smooth(40, 24, 5)
    data = pil_jpeg(arr, quality=92, subsampling=0)
    dec = JpegDecoder(data, DecoderOptions(force_owned=True))
    header = dec.get_header()
    assert (header.width, header.height) == (40, 24)
    rows = np.vstack(list(dec.bands(16)))
    rgba = rows.reshape(24, 40, 4)
    assert (rgba[:, :, 3] == 255).all()
    assert np.abs(rgba[:, :, :3].astype(int) - pil_decode(data)).mean() < 2.0


def test_crafted_sof_zero_sampling_rejected():
    """SOF declaring sampling factor 0 must raise StitchError, not
    ZeroDivisionError (sampling factors are 1..4 per T.81 B.2.2)."""
    arr = smooth(16, 16)
    data = bytearray(pil_jpeg(arr, quality=85, subsampling=0))
    # Find SOF0 and zero the first component's h/v byte.
    i = data.find(b"\xff\xc0")
    assert i >= 0
    hv_off = i + 4 + 6 + 1  # marker+len+prec+dims+nc, comp0: id, hv
    data[hv_off] = 0x00
    with pytest.raises(StitchError, match="sampling"):
        decode_baseline_jpeg(bytes(data))


def test_crafted_sos_unknown_component_rejected():
    """SOS referencing a component id absent from SOF must raise
    StitchError, not StopIteration."""
    arr = smooth(16, 16)
    data = bytearray(pil_jpeg(arr, quality=85, subsampling=0))
    i = data.find(b"\xff\xda")
    assert i >= 0
    data[i + 5] = 0xEE  # first scan component id -> unknown
    with pytest.raises(StitchError, match="unknown component"):
        decode_baseline_jpeg(bytes(data))


@pytest.mark.parametrize("seed", range(24))
def test_differential_fuzz_vs_pil(seed):
    """Randomized differential fuzz: arbitrary content, dims, quality,
    subsampling, progressive flag, restart cadence — the owned decoder
    must be BIT-IDENTICAL to PIL/libjpeg on every valid stream (same
    latent-bug class as the deflate length-limiter find: a clean run
    diverging on unlucky inputs)."""
    from PIL import Image

    rng = np.random.default_rng(7000 + seed)
    w = int(rng.integers(8, 120))
    h = int(rng.integers(8, 120))
    kind = int(rng.integers(0, 3))
    if kind == 0:
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif kind == 1:
        x = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
        arr = np.clip(x + rng.integers(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)
    else:
        arr = np.full((h, w, 3), rng.integers(0, 256, 3, dtype=np.uint8)[None, None])
    kwargs = {
        "quality": int(rng.choice([30, 60, 85, 95, 100])),
        "subsampling": int(rng.choice([0, 1, 2])),
    }
    if rng.random() < 0.5:
        kwargs["progressive"] = True
    if rng.random() < 0.3:
        kwargs["restart_marker_blocks"] = int(rng.integers(1, 8))
    buf = io.BytesIO()
    try:
        Image.fromarray(arr, "RGB").save(buf, format="JPEG", **kwargs)
    except (OSError, ValueError):
        pytest.skip("PIL rejected this parameter combo")
    data = buf.getvalue()
    np.testing.assert_array_equal(
        decode_baseline_jpeg(data), pil_decode(data),
        err_msg=f"seed {seed} kwargs {kwargs} dims {w}x{h}",
    )


def test_gray_subsampled_single_component_scans_match_pil():
    """Single-component scans are NON-interleaved (T.81 A.2): one block
    per data unit over the component's own grid, restarts in blocks —
    even when the SOF carries sampling factors > 1 (PIL writes gray with
    the requested subsampling's factors). The session-5 soak caught both
    tiers decoding these MCU-interleaved (wrong order + wrong restart
    cadence). Covers baseline + progressive, with and without restarts."""
    from PIL import Image

    import image_stitch_tpu.codecs.jpeg.owned_decoder as od

    rng = np.random.default_rng(3)
    for h, w, kw in (
        (20, 43, dict(subsampling=1, restart_marker_blocks=3)),
        (132, 98, dict(subsampling=1)),
        (93, 50, dict(subsampling=2, progressive=True,
                      restart_marker_blocks=4)),
        (64, 40, dict(subsampling=2, progressive=True)),
    ):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=40, **kw)
        own = od.decode_baseline_jpeg(buf.getvalue())
        pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("L"))
        assert np.array_equal(own[:, :, 0], pil), kw


def test_narrow_subsampled_images_use_replication_upsample():
    """libjpeg selects the fancy h2v1/h2v2 filters only when the
    downsampled chroma width > 2 (jinit_upsampler); 1-4 px wide
    subsampled images replicate instead. Session-5 soak find."""
    from PIL import Image

    import image_stitch_tpu.codecs.jpeg.owned_decoder as od

    rng = np.random.default_rng(4)
    for w in (1, 2, 3, 4):
        for sub in (1, 2):
            img = rng.integers(0, 256, (151, w, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=74, subsampling=sub)
            own = od.decode_baseline_jpeg(buf.getvalue())
            pil = np.asarray(
                Image.open(io.BytesIO(buf.getvalue())).convert("RGB")
            )
            assert np.array_equal(own, pil), (w, sub)


def _jpeg_bit_writer():
    """Minimal MSB-first JPEG entropy bit writer with 0xFF00 stuffing."""
    out = bytearray()
    state = {"acc": 0, "n": 0}

    def put(bits, n):
        state["acc"] = (state["acc"] << n) | (bits & ((1 << n) - 1))
        state["n"] += n
        while state["n"] >= 8:
            state["n"] -= 8
            b = (state["acc"] >> state["n"]) & 0xFF
            out.append(b)
            if b == 0xFF:
                out.append(0x00)

    def flush():
        if state["n"]:
            pad = 8 - state["n"]
            put((1 << pad) - 1, pad)
        return bytes(out)

    return put, flush


def _encode_block(put, blk, pred, dc_codes, ac_codes):
    """Encode one natural-order coefficient block (T.81 F.1.2)."""
    from image_stitch_tpu.codecs.jpeg.tables import ZIGZAG

    def magnitude(v):
        size = int(abs(v)).bit_length()
        bits = v if v >= 0 else v + (1 << size) - 1
        return size, bits

    diff = int(blk[0]) - pred
    size, bits = magnitude(diff)
    code, length = dc_codes[size]
    put(code, length)
    if size:
        put(bits, size)
    run = 0
    zz = [int(blk[ZIGZAG[k]]) for k in range(64)]
    last_nz = max((k for k in range(1, 64) if zz[k]), default=0)
    for k in range(1, last_nz + 1):
        v = zz[k]
        if v == 0:
            run += 1
            continue
        while run > 15:
            code, length = ac_codes[0xF0]  # ZRL
            put(code, length)
            run -= 16
        size, bits = magnitude(v)
        code, length = ac_codes[(run << 4) | size]
        put(code, length)
        put(bits, size)
        run = 0
    if last_nz < 63:
        code, length = ac_codes[0x00]  # EOB
        put(code, length)
    return int(blk[0])


def test_multi_scan_sequential_baseline_matches_pil():
    """T.81 allows baseline sequential files with SEVERAL scans (e.g. a
    non-interleaved scan per component); libjpeg decodes them. Craft one
    with the standard tables and verify the owned decoder against PIL
    pixel-exactly (the decoder must accumulate scans and finish at EOI,
    not return after the first SOS)."""
    import io

    from PIL import Image

    from image_stitch_tpu.codecs.jpeg.tables import (
        STD_AC_LUMA_BITS, STD_AC_LUMA_VALS, STD_DC_LUMA_BITS,
        STD_DC_LUMA_VALS, ZIGZAG, build_huffman_codes,
    )

    rng = np.random.default_rng(23)
    h, w = 16, 24
    by, bx = h // 8, w // 8

    # One shared quant table / Huffman table pair keeps the file small.
    qtab = np.full(64, 16, np.int32)
    dc = build_huffman_codes(STD_DC_LUMA_BITS, STD_DC_LUMA_VALS)
    ac = build_huffman_codes(STD_AC_LUMA_BITS, STD_AC_LUMA_VALS)

    comps_blocks = []
    for _ in range(3):
        blocks = np.zeros((by * bx, 64), np.int32)
        blocks[:, 0] = rng.integers(-40, 40, by * bx)
        for b in range(by * bx):
            for k in rng.choice(np.arange(1, 20), 5, replace=False):
                blocks[b, ZIGZAG[k]] = int(rng.integers(-15, 16))
        comps_blocks.append(blocks)

    out = bytearray(b"\xff\xd8")
    # DQT (table 0, zigzag order)
    zz_q = bytes(int(qtab[ZIGZAG[k]]) for k in range(64))
    out += b"\xff\xdb" + (67).to_bytes(2, "big") + b"\x00" + zz_q
    # SOF0: 3 components, h=v=1, all quant table 0
    sof = bytearray()
    sof += bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([3])
    for cid in (1, 2, 3):
        sof += bytes([cid, 0x11, 0])
    out += b"\xff\xc0" + (2 + len(sof)).to_bytes(2, "big") + sof
    # DHT: DC table 0 + AC table 0
    dht = bytearray()
    # DHT Li fields are L1..L16 (the tables module keeps index 0 unused).
    dht += b"\x00" + bytes(STD_DC_LUMA_BITS[1:17]) + bytes(STD_DC_LUMA_VALS)
    dht += b"\x10" + bytes(STD_AC_LUMA_BITS[1:17]) + bytes(STD_AC_LUMA_VALS)
    out += b"\xff\xc4" + (2 + len(dht)).to_bytes(2, "big") + dht
    # One non-interleaved scan per component.
    for ci, cid in enumerate((1, 2, 3)):
        sos = bytes([1, cid, 0x00, 0, 63, 0])
        out += b"\xff\xda" + (2 + len(sos)).to_bytes(2, "big") + sos
        put, flush = _jpeg_bit_writer()
        pred = 0
        for b in range(by * bx):
            pred = _encode_block(put, comps_blocks[ci][b], pred, dc, ac)
        out += flush()
    out += b"\xff\xd9"
    data = bytes(out)

    from image_stitch_tpu.codecs.jpeg.owned_decoder import decode_baseline_jpeg

    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    own = decode_baseline_jpeg(data)
    assert np.array_equal(own, pil)
