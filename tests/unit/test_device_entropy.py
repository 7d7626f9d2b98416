"""On-device JPEG entropy packer tests: byte-exact vs the host coder across
bands with DC/bit carries, ZRL run splitting, and the fused band program."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from image_stitch_tpu.codecs.jpeg.encoder import _band_to_blocks_numpy
from image_stitch_tpu.codecs.jpeg.huffman import (
    BitPacker,
    HuffmanEncoder,
    interleave_mcus,
)
from image_stitch_tpu.codecs.jpeg.tables import (
    STD_AC_CHROMA_BITS,
    STD_AC_CHROMA_VALS,
    STD_AC_LUMA_BITS,
    STD_AC_LUMA_VALS,
    STD_DC_CHROMA_BITS,
    STD_DC_CHROMA_VALS,
    STD_DC_LUMA_BITS,
    STD_DC_LUMA_VALS,
    build_huffman_codes,
    quality_scaled_tables,
)
from image_stitch_tpu.ops.jpeg_entropy_device import (
    DeviceEntropyPacker,
    DeviceJpegEncoder,
)

DC_L = build_huffman_codes(STD_DC_LUMA_BITS, STD_DC_LUMA_VALS)
AC_L = build_huffman_codes(STD_AC_LUMA_BITS, STD_AC_LUMA_VALS)
DC_C = build_huffman_codes(STD_DC_CHROMA_BITS, STD_DC_CHROMA_VALS)
AC_C = build_huffman_codes(STD_AC_CHROMA_BITS, STD_AC_CHROMA_VALS)


def host_encode(bands, flush=True):
    encl, encc = HuffmanEncoder(DC_L, AC_L), HuffmanEncoder(DC_C, AC_C)
    packer = BitPacker()
    prev = [0, 0, 0]
    out = b""
    for yb, cbb, crb in bands:
        yc, yl, prev[0] = encl.encode_component_blocks(yb, prev[0])
        cbc, cbl, prev[1] = encc.encode_component_blocks(cbb, prev[1])
        crc, crl, prev[2] = encc.encode_component_blocks(crb, prev[2])
        codes, lens = interleave_mcus([(yc, yl), (cbc, cbl), (crc, crl)])
        out += packer.pack(codes, lens)
    if flush:
        out += packer.flush()
    return out


def device_encode(bands, n_pixels):
    dev = DeviceEntropyPacker(DC_L, AC_L, DC_C, AC_C)
    out = b"".join(dev.pack_band(*b, n_pixels) for b in bands)
    return out + dev.flush()


def blocks_from(seed, h=64, w=128, smooth=False):
    rng = np.random.default_rng(seed)
    lq, cq = quality_scaled_tables(85)
    if smooth:
        x = np.linspace(0, 250, w, dtype=np.uint8)
        band = np.zeros((h, w, 4), np.uint8)
        band[:, :, 0] = x[None, :]
        band[:, :, 1] = 128
        band[:, :, 2] = x[None, ::-1]
    else:
        band = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    return _band_to_blocks_numpy(band, lq, cq)


def test_single_band_exact():
    b = blocks_from(0)
    assert device_encode([b], 64 * 128) == host_encode([b])


def test_multiband_carry_exact():
    bands = [blocks_from(s, smooth=s % 2 == 1) for s in range(4)]
    assert device_encode(bands, 64 * 128) == host_encode(bands)


def test_zrl_run_splitting():
    # Sparse blocks exercising runs of 16..62 incl. trailing-zero EOB.
    yb = np.zeros((4, 64), np.int16)
    yb[0, 0] = 100
    yb[1, 18] = 5  # zigzag-dependent long run
    yb[2, 63] = -1  # maximal run to last coefficient
    yb[3, 1] = 1
    cb = np.zeros((4, 64), np.int16)
    cr = np.zeros((4, 64), np.int16)
    cr[0, 35] = -7
    b = (yb, cb, cr)
    assert device_encode([b], 32 * 64) == host_encode([b])


def test_extreme_values():
    rng = np.random.default_rng(3)
    yb = rng.integers(-1023, 1024, (8, 64)).astype(np.int16)
    cb = rng.integers(-1023, 1024, (8, 64)).astype(np.int16)
    cr = rng.integers(-1023, 1024, (8, 64)).astype(np.int16)
    b = (yb, cb, cr)
    # High-entropy blocks exceed the 12-bpp device budget and take the host
    # fallback inside pack_band — the stream must still be exact.
    assert device_encode([b], 8 * 8) == host_encode([b])


def test_capacity_overflow_falls_back():
    rng = np.random.default_rng(4)
    b = tuple(rng.integers(-1023, 1024, (4, 64)).astype(np.int16) for _ in range(3))
    dev = DeviceEntropyPacker(DC_L, AC_L, DC_C, AC_C, cap_bits_per_px=1)
    out = dev.pack_band(*b, 4 * 64) + dev.flush()
    assert out == host_encode([b])


def test_fused_device_encoder_matches_host_entropy():
    lq, cq = quality_scaled_tables(85)
    rng = np.random.default_rng(5)
    x = np.linspace(10, 240, 128, dtype=np.uint8)
    band1 = np.zeros((32, 128, 4), np.uint8)
    band1[:, :, 0] = x[None, :]
    band1[:, :, 1] = x[None, ::-1]
    band1[:, :, 3] = 255
    band2 = rng.integers(0, 256, (32, 128, 4), dtype=np.uint8)
    enc = DeviceJpegEncoder(lq, cq, DC_L, AC_L, DC_C, AC_C)
    h1 = enc.submit(band1)
    h2 = enc.submit(band2)  # submitted before waiting: carry stays on device
    out = enc.wait(h1) + enc.wait(h2) + enc.flush()
    expected = host_encode(
        [_band_to_blocks_numpy(band1, lq, cq), _band_to_blocks_numpy(band2, lq, cq)]
    )
    # Device DCT (XLA) and host DCT (numpy f32) agree on these inputs.
    assert out == expected


def test_fused_encoder_overflow_falls_back_to_host():
    """When max_block_bits exceeds the 768-bit local budget the fused
    encoder must host-code the band from the device's own quantized blocks
    (bit-identical stream). Forced via a doctored handle — real q100 noise
    peaks at ~761 bits/block, just under the budget."""
    import jax.numpy as jnp

    lq, cq = quality_scaled_tables(100)
    rng = np.random.default_rng(6)
    band = rng.integers(0, 256, (16, 64, 4), dtype=np.uint8)
    enc = DeviceJpegEncoder(lq, cq, DC_L, AC_L, DC_C, AC_C)
    h = enc.submit(band)
    forced = (h[0], h[1], h[2], jnp.int32(10_000), h[4], h[5], h[6], h[7])
    blocks = tuple(np.asarray(b) for b in h[5])
    out = enc.wait(forced) + enc.flush()
    expected = host_encode([blocks])
    assert out == expected


def test_native_coder_dense_blocks_no_overflow():
    """Adversarial dense size-10 blocks (~314 stuffed bytes/block) must not
    overflow the native output buffer: the C++ writer bounds-checks per MCU
    and the Python buffer is sized at the structural worst case."""
    from image_stitch_tpu.native import (
        NativeEntropyCoder,
        make_huff_table,
        native_available,
    )

    if not native_available():
        pytest.skip("native tier unavailable")
    def dense(n):
        # Every coefficient +1023: size-10 magnitude bits are all ones, so
        # the stream is nearly all 0xFF bytes and stuffing almost doubles it.
        return np.full((n, 64), 1023, dtype=np.int16)

    n = 64
    yb, cb, cr = dense(n), dense(n), dense(n)
    coder = NativeEntropyCoder(
        make_huff_table(DC_L, AC_L), make_huff_table(DC_C, AC_C)
    )
    out = coder.encode(yb, cb, cr) + coder.flush()
    assert out == host_encode([(yb, cb, cr)])
    # Confirm this really is the worst-case regime the old 256 B/block
    # buffer could not hold.
    assert len(out) > n * 3 * 260


def test_groups_full_cap_falls_back_exactly():
    """A restart group whose bitstream exactly fills its word capacity must
    take the host fallback (the dense repack's end-histogram would alias its
    last word) and still produce byte-identical output."""
    import numpy as np

    from image_stitch_tpu.codecs.jpeg.encoder import StreamingJpegEncoder

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (32, 64, 4), dtype=np.uint8)  # noisy
    # q100 maximizes bits/px so tight caps overflow-or-fill quickly.
    def enc(backend):
        e = StreamingJpegEncoder(64, 32, 100, backend=backend,
                                 restart_interval_rows=1)
        if backend == "jax" and e._dev_encoder is not None:
            e._dev_encoder._cap_bits_per_px = 3  # keep tight, no promotion room
        out = b""
        for c in e.encode_band(img):
            out += c
        for c in e.finish():
            out += c
        return out

    assert enc("jax") == enc("numpy")


def _stream_jpeg(backend, img, quality=85, tweak=None):
    from image_stitch_tpu.codecs.jpeg.encoder import StreamingJpegEncoder

    e = StreamingJpegEncoder(img.shape[1], img.shape[0], quality,
                             backend=backend, restart_interval_rows=1)
    if tweak is not None and e._dev_encoder is not None:
        tweak(e._dev_encoder)
    out = b""
    for c in e.encode_band(img):
        out += c
    for c in e.finish():
        out += c
    return out, e._dev_encoder


def test_groups_flat_content_single_pass_hybrid():
    """Flat content packs tiny blocks (DC size-0 + EOB, ~6-7 bits), so >4
    blocks share an output word. The default hybrid merge is exact for
    any per-word overlap, so the band packs in ONE dispatch — no re-pack,
    merge mode unchanged."""
    img = np.full((32, 128, 4), 128, np.uint8)
    dev_bytes, dev_enc = _stream_jpeg("jax", img)
    host_bytes, _ = _stream_jpeg("numpy", img)
    assert dev_bytes == host_bytes
    assert dev_enc is not None and dev_enc._merge_mode == "hybrid"


def test_groups_flat_content_repacks_on_device_segsum():
    """With the gather merge forced (bounded per-word overlap), flat
    content exceeds K_OVERLAP and the encoder must RE-PACK on-device with
    the scatter-add merge (bit-equivalent, no overlap bound) — not
    host-code — and flip the sticky merge mode for subsequent bands."""
    img = np.full((32, 128, 4), 128, np.uint8)

    def force_gather(enc):
        enc._merge_mode = "gather"

    dev_bytes, dev_enc = _stream_jpeg("jax", img, tweak=force_gather)
    host_bytes, _ = _stream_jpeg("numpy", img)
    assert dev_bytes == host_bytes
    assert dev_enc is not None and dev_enc._merge_mode == "segsum"


def test_groups_pooled_capacity_repacks_on_device():
    """A too-tight pooled capacity re-packs on-device at the exact needed
    capacity (known from the fetched per-group bit counts) and feeds the
    observed bits/px into the adaptive budget for the next band."""
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (32, 128, 4), dtype=np.uint8)  # noisy

    def tighten(enc):
        enc._cap_bits_per_px = 1  # q85 noise runs well above 1 bit/px

    dev_bytes, dev_enc = _stream_jpeg("jax", img, tweak=tighten)
    host_bytes, _ = _stream_jpeg("numpy", img)
    assert dev_bytes == host_bytes
    assert dev_enc is not None and len(dev_enc._cap_recent) > 0
    # The next submit would budget from the observed peak, not the config
    # (clamped at MAX_CAP_BITS_PER_PX: beyond-max content — full-range q85
    # noise packs ~12.8 bits/px — re-packs at exact capacity every band).
    from image_stitch_tpu.ops.jpeg_entropy_device import MAX_CAP_BITS_PER_PX

    assert dev_enc._group_cap_bits_px() >= min(
        max(dev_enc._cap_recent), float(MAX_CAP_BITS_PER_PX)
    )


def test_groups_block_budget_repacks_with_bigger_local_words():
    """A block exceeding the per-block word budget re-packs with the next
    budget rung that fits (sticky) instead of host-coding."""
    rng = np.random.default_rng(22)
    img = rng.integers(0, 256, (16, 64, 4), dtype=np.uint8)

    def shrink(enc):
        enc._local_words = 2  # 64-bit blocks: q85 noise blows through this

    dev_bytes, dev_enc = _stream_jpeg("jax", img, tweak=shrink)
    host_bytes, _ = _stream_jpeg("numpy", img)
    assert dev_bytes == host_bytes
    assert dev_enc is not None and dev_enc._local_words > 2


def test_adaptive_cap_shrinks_on_quiet_content():
    """After one observed band, the capacity budget tracks content (bucketed
    observed peak * 1.15) instead of the static default — the merge scans the
    whole allocated output, so this is a first-order device-time lever."""
    x = np.linspace(10, 240, 128, dtype=np.uint8)
    img = np.zeros((64, 128, 4), np.uint8)
    img[:, :, 0] = x[None, :]
    img[:, :, 1] = x[None, ::-1]
    img[:, :, 3] = 255
    dev_bytes, dev_enc = _stream_jpeg("jax", img)
    host_bytes, _ = _stream_jpeg("numpy", img)
    assert dev_bytes == host_bytes
    assert dev_enc is not None and len(dev_enc._cap_recent) > 0
    assert dev_enc._group_cap_bits_px() < 3.0  # smooth gradient packs small


def test_merge_strategies_bit_identical():
    """The three phase-2 merges (K-round gather, sorted scatter-add, and
    the hybrid one-gather + starter scatter) are bit-equivalent packings:
    same dense words on noise, smooth, and sparse content. Flat content
    (tiny DC+EOB blocks, many per output word) exceeds the gather merge's
    K_OVERLAP bound, so there hybrid is checked against segsum only —
    the case the hybrid exists for (exact with NO per-word overlap bound)."""
    from image_stitch_tpu.ops.jpeg_entropy_device import (
        K_OVERLAP,
        build_entropy_luts,
        jpeg_pack_groups_from_blocks_trace,
    )

    luts = build_entropy_luts(DC_L, AC_L, DC_C, AC_C)
    luts = {k: jnp.asarray(v) for k, v in luts.items()}

    # cap_words must hold the content (q85 noise ~13 bits/px, 2048 px per
    # group): overflowed pools clip the merge histograms into garbage.
    def pack(blocks, merge, n_groups=4, cap_words=2048):
        yb, cbb, crb = (jnp.asarray(b) for b in blocks)
        dense, gbits, _, max_ov = jpeg_pack_groups_from_blocks_trace(
            yb, cbb, crb, luts, n_groups, cap_words, merge=merge
        )
        return np.asarray(dense), np.asarray(gbits), int(max_ov)

    cases = {
        "noise": blocks_from(7, h=32, w=256),
        "smooth": blocks_from(8, h=32, w=256, smooth=True),
    }
    zeros = tuple(np.zeros((16, 64), np.int16) for _ in range(3))
    for name, blocks in cases.items():
        d_g, b_g, ov = pack(blocks, "gather")
        d_s, b_s, _ = pack(blocks, "segsum")
        d_h, b_h, _ = pack(blocks, "hybrid")
        assert ov <= K_OVERLAP, name  # gather result only valid then
        np.testing.assert_array_equal(b_g, b_s, err_msg=name)
        np.testing.assert_array_equal(b_g, b_h, err_msg=name)
        np.testing.assert_array_equal(d_g, d_s, err_msg=name)
        np.testing.assert_array_equal(d_g, d_h, err_msg=name)
    # Flat: ~6-7-bit blocks, >K_OVERLAP per word — gather is out of spec.
    d_s, b_s, _ = pack(zeros, "segsum")
    d_h, b_h, _ = pack(zeros, "hybrid")
    np.testing.assert_array_equal(b_s, b_h)
    np.testing.assert_array_equal(d_s, d_h)


def test_batched_dispatch_bytes_identical():
    """batch_bands > 1 coalesces group-aligned bands into ONE flat device
    dispatch (restart groups carry no inter-band state);
    bytes must be identical to unbatched across: full batches, a partial
    final batch, and a tail (shorter final group)."""
    from image_stitch_tpu.codecs.jpeg.encoder import StreamingJpegEncoder

    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (88, 64, 4), dtype=np.uint8)  # 11 MCU rows

    def run(backend, batch, band_h):
        e = StreamingJpegEncoder(64, 88, 85, backend=backend,
                                 restart_interval_rows=2)
        if batch and e._dev_encoder is not None:
            e._dev_encoder._batch_bands = batch
        out = b""
        for y in range(0, img.shape[0], band_h):
            for c in e.encode_band(img[y : y + band_h]):
                out += c
        for c in e.finish():
            out += c
        return out

    # 88 rows at ri=2 -> 5 full 16-row groups + a 1-MCU-row tail. band_h=32
    # gives 2-group bands; batch=3 leaves a partial batch for the tail
    # dispatch to flush; batch=8 never fills and relies on flush_pending.
    ref = run("numpy", 0, 32)
    assert run("jax", 0, 32) == ref
    assert run("jax", 3, 32) == ref
    assert run("jax", 8, 32) == ref
    assert run("jax", 2, 16) == ref


def test_batched_dispatch_env_knob(monkeypatch):
    """STITCH_TPU_DEVICE_BATCH wires through to the device encoder and the
    batched stream still matches the host bytes exactly."""
    from image_stitch_tpu.codecs.jpeg.encoder import StreamingJpegEncoder

    monkeypatch.setenv("STITCH_TPU_DEVICE_BATCH", "4")
    rng = np.random.default_rng(32)
    img = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)

    def run(backend):
        e = StreamingJpegEncoder(64, 64, 85, backend=backend,
                                 restart_interval_rows=1)
        if backend == "jax":
            assert e._dev_encoder._batch_bands == 4
        out = b""
        for y in range(0, img.shape[0], 16):
            for c in e.encode_band(img[y : y + 16]):
                out += c
        for c in e.finish():
            out += c
        return out

    assert run("jax") == run("numpy")


def test_zz_permute_matmul_exact():
    """The zigzag reorder (0/1 permutation matmul) must equal the plain
    gather for the full quantized-coefficient range: each output is a
    single exact f32 product (|coef| <= 2047 << 2^24)."""
    import numpy as np

    from image_stitch_tpu.codecs.jpeg.tables import ZIGZAG
    from image_stitch_tpu.ops.jpeg_entropy_device import _zz_permute

    rng = np.random.default_rng(0)
    seq = rng.integers(-2047, 2048, (257, 64)).astype(np.int32)
    seq[0] = 2047
    seq[1] = -2047
    got = np.asarray(_zz_permute(jnp.asarray(seq)))
    np.testing.assert_array_equal(got, seq[:, np.asarray(ZIGZAG)])


def test_bit_size_exponent_trick_exhaustive():
    """_bit_size reads floor(log2)+1 from the f32 exponent; must equal the
    definitional bit length for every JPEG-reachable magnitude and beyond."""
    import numpy as np

    from image_stitch_tpu.ops.jpeg_entropy_device import _bit_size

    v = np.arange(-4096, 4097, dtype=np.int32)
    got = np.asarray(_bit_size(jnp.asarray(v), 13))
    exp = np.array([int(abs(int(x))).bit_length() for x in v], dtype=np.int32)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_prev_nonzero_scan_matches_loop(density):
    """cummax run-length scan: inclusive running max of nonzero AC
    positions, its one-step shift, and the last nonzero position."""
    from image_stitch_tpu.ops.jpeg_entropy_device import _prev_nonzero_scan

    rng = np.random.default_rng(int(density * 10))
    nz = rng.random((97, 63)) < density
    pos = np.broadcast_to(np.arange(1, 64, dtype=np.int32), nz.shape)
    incl, prev_nz, last_nz = (
        np.asarray(a) for a in _prev_nonzero_scan(jnp.asarray(nz), jnp.asarray(pos))
    )
    exp = np.maximum.accumulate(np.where(nz, pos, 0), axis=1)
    np.testing.assert_array_equal(incl, exp)
    np.testing.assert_array_equal(prev_nz[:, 1:], exp[:, :-1])
    np.testing.assert_array_equal(prev_nz[:, 0], 0)
    np.testing.assert_array_equal(last_nz, exp[:, -1])


@pytest.mark.parametrize("inclusive", [False, True])
def test_rank_sorted_matches_searchsorted(inclusive):
    """_rank_sorted(idx, cap)[w] = #{b : idx[b] < w} (<= w inclusive)."""
    from image_stitch_tpu.ops.jpeg_entropy_device import _rank_sorted

    rng = np.random.default_rng(3)
    idx = np.sort(rng.integers(0, 700, 5000)).astype(np.int32)
    got = np.asarray(_rank_sorted(jnp.asarray(idx), 700, inclusive))
    side = "right" if inclusive else "left"
    np.testing.assert_array_equal(got, np.searchsorted(idx, np.arange(700), side))
