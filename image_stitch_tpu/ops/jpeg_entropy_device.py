"""On-device JPEG entropy packing — the bitstream assembled on the device.

The classic view is that Huffman coding is "inherently serial" and must live
on the host (the reference ships it to a Rust/WASM module; SURVEY §2 item 1).
The device reframing: entropy coding is a *data-parallel symbol map*
followed by a *prefix-sum over bit lengths* followed by a *scatter of code
bits to word offsets* — all parallel primitives:

1. Per coefficient (vectorized over every block of a band): run lengths via
   an exclusive cumulative max of nonzero positions, JPEG size categories via
   comparison ladders, Huffman (code, length) via LUT gathers, value bits
   appended arithmetically. Exactly one symbol slot per coefficient: a zero
   coefficient that is the 16th of a run emits ZRL; others emit nothing
   (length 0).
2. ``jnp.cumsum`` of lengths -> absolute bit offsets (carried across bands
   through ``bit_base``).
3. Each symbol's ≤26 bits are ORed into one or two 32-bit words via two
   sorted segment-sums — non-overlapping bit ranges make addition equal OR.

Only the packed words (≈ the final compressed size, ~1-6 bits/pixel) cross
back to the host; the host merely applies 0xFF byte stuffing and the
sub-byte carry between bands. DC predictors ride through ``prev_dc``.

Output is verified byte-identical to the host (C++/numpy) entropy coders.
"""

from __future__ import annotations

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs.jpeg.tables import ZIGZAG
from ..utils.observability import count

# Capacity headroom: packed output budget in bits per pixel. Baseline q85
# photos run 1-2 bpp. Phase-2 merge work is proportional to this capacity,
# so start tight; on overflow the encoder host-codes that band (exact) and
# promotes the budget for subsequent bands (one recompile per promotion).
DEFAULT_CAP_BITS_PER_PX = 3
MAX_CAP_BITS_PER_PX = 12


def _bit_size(v: jax.Array, max_bits: int) -> jax.Array:
    """JPEG size category: number of magnitude bits.

    floor(log2(mag)) + 1 read straight from the f32 exponent field — exact
    because every JPEG magnitude (|v| <= 2047 for DC diffs, <= 1023 for AC)
    is exactly representable in f32, so the exponent is exactly
    floor(log2). ~4 elementwise ops instead of a ``max_bits``-long compare-add
    chain (the chain was a visible slice of the symbols stage).
    """
    mag = jnp.abs(v.astype(jnp.int32))
    fbits = jax.lax.bitcast_convert_type(mag.astype(jnp.float32), jnp.int32)
    size = (fbits >> 23) - 126  # biased exponent -> floor(log2)+1 for mag>=1
    return jnp.where(mag == 0, 0, size)


def _zz_permute(seq: jax.Array) -> jax.Array:
    """Zigzag-reorder (B, 64) int32 natural-order coefficients as a 0/1
    permutation matmul (on the GPU it beat the 64-wide gather; PERF.md).
    Exact: each output is one product coef * 1.0 plus exact zeros,
    |coef| <= 2047 < 2^24, and HIGHEST precision keeps full f32 products
    (TF32 would round values above 2048)."""
    p = np.zeros((64, 64), np.float32)
    p[np.asarray(ZIGZAG), np.arange(64)] = 1.0
    zz = jnp.dot(
        seq.astype(jnp.float32), jnp.asarray(p),
        precision=jax.lax.Precision.HIGHEST,
    )
    return zz.astype(jnp.int32)


def _prev_nonzero_scan(nz, pos):
    """(incl_cummax, prev_nz, last_nz) for the AC run-length computation:
    the inclusive running max of nonzero positions along each block."""
    incl = jax.lax.cummax(jnp.where(nz, pos, 0), axis=1)
    prev_nz = jnp.pad(incl[:, :-1], ((0, 0), (1, 0)))
    return incl, prev_nz, incl[:, -1]


def entropy_pack_trace(
    yb: jax.Array,  # (N, 64) int16/int32 natural-order quantized Y blocks
    cbb: jax.Array,
    crb: jax.Array,
    luts: dict,  # dict of LUT arrays (see build_entropy_luts)
    prev_dc: jax.Array,  # (3,) int32
    bit_base: jax.Array,  # () int32 in [0, 8): carry bits from previous band
    cap_words: int,  # static output capacity in 32-bit words
):
    """Returns (words (cap_words,) uint32, total_bits () int32,
    new_prev_dc (3,) int32). 4:4:4 interleave (Y, Cb, Cr per MCU)."""
    n = yb.shape[0]
    zigzag = jnp.asarray(ZIGZAG)

    # Interleave to scan order: (3N, 64), zigzag-ordered coefficients.
    seq = jnp.stack([yb, cbb, crb], axis=1).reshape(3 * n, 64).astype(jnp.int32)
    zz = seq[:, zigzag]
    # Table select per block: 0 = luma, 1 = chroma.
    tsel = jnp.tile(jnp.asarray([0, 1, 1], dtype=jnp.int32), n)

    # ---- DC: per-component differential ---------------------------------
    dc = zz[:, 0].reshape(n, 3)
    prev = jnp.concatenate([prev_dc[None, :], dc[:-1]], axis=0)
    diffs = (dc - prev).reshape(3 * n)
    dsz = _bit_size(diffs, 12)
    dval = jnp.where(diffs < 0, diffs + (1 << dsz) - 1, diffs) & (
        (1 << dsz) - 1
    )
    dcode = luts["dc_code"][tsel, dsz]
    dlen = luts["dc_len"][tsel, dsz]
    dc_codes = ((dcode << dsz) | dval.astype(jnp.uint32)).astype(jnp.uint32)
    dc_lens = (dlen + dsz).astype(jnp.int32)

    # ---- AC: one slot per coefficient position 1..63 --------------------
    v = zz[:, 1:]  # (3N, 63)
    nz = v != 0
    pos = jnp.broadcast_to(jnp.arange(1, 64, dtype=jnp.int32), v.shape)
    incl_cummax, prev_nz, last_nz = _prev_nonzero_scan(nz, pos)  # (3N,)

    run = pos - prev_nz - 1
    asz = _bit_size(v, 11)
    aval = jnp.where(v < 0, v + (1 << asz) - 1, v) & ((1 << asz) - 1)
    sym = ((run % 16) << 4) | asz
    acode = luts["ac_code"][tsel[:, None], sym]
    alen = luts["ac_len"][tsel[:, None], sym]
    main_codes = ((acode << asz) | aval.astype(jnp.uint32)).astype(jnp.uint32)
    main_lens = jnp.where(nz, alen + asz, 0).astype(jnp.int32)

    # Zero coefficients that are the 16th of a run before a later nonzero
    # emit ZRL (run splitting, T.81 F.1.2.2.1).
    zrl_here = (~nz) & ((pos - prev_nz) % 16 == 0) & (pos < last_nz[:, None])
    zrl_codes = jnp.broadcast_to(
        luts["zrl_code"][tsel][:, None], v.shape
    ).astype(jnp.uint32)
    zrl_lens = jnp.where(zrl_here, luts["zrl_len"][tsel][:, None], 0).astype(
        jnp.int32
    )

    ac_codes = jnp.where(nz, main_codes, zrl_codes)
    ac_lens = jnp.where(nz, main_lens, zrl_lens)

    # ---- EOB -------------------------------------------------------------
    need_eob = last_nz != 63
    eob_codes = luts["eob_code"][tsel].astype(jnp.uint32)
    eob_lens = jnp.where(need_eob, luts["eob_len"][tsel], 0).astype(jnp.int32)

    # ---- Assemble symbol stream: [dc | ac(63) | eob] per block ----------
    codes = jnp.concatenate(
        [dc_codes[:, None], ac_codes, eob_codes[:, None]], axis=1
    ).reshape(-1)
    lens = jnp.concatenate(
        [dc_lens[:, None], ac_lens, eob_lens[:, None]], axis=1
    ).reshape(-1)
    # Length-0 slots must contribute no bits — zero their codes, otherwise
    # the scatter ORs their (meaningless) code bits at a shared offset.
    codes = jnp.where(lens > 0, codes, jnp.uint32(0))

    # ---- Bit offsets ------------------------------------------------------
    ends = bit_base.astype(jnp.int32) + jnp.cumsum(lens)
    total_bits = ends[-1]
    offs = ends - lens  # start bit of each symbol

    # ---- Scatter code bits into 32-bit words -----------------------------
    w0 = offs >> 5
    # Right overhang of the symbol past the end of word w0.
    over = ends - ((w0 + 1) << 5)
    codes32 = codes.astype(jnp.uint32)
    shift_l = jnp.clip(-over, 0, 31).astype(jnp.uint32)
    shift_r = jnp.clip(over, 0, 31).astype(jnp.uint32)
    in_one = over <= 0
    contrib0 = jnp.where(in_one, codes32 << shift_l, codes32 >> shift_r)
    contrib1 = jnp.where(
        in_one,
        jnp.uint32(0),
        (codes32 << jnp.clip(32 - over, 0, 31).astype(jnp.uint32)),
    )
    w1 = jnp.where(in_one, w0, w0 + 1)

    w0c = jnp.clip(w0, 0, cap_words)
    w1c = jnp.clip(w1, 0, cap_words)
    words = jax.ops.segment_sum(
        contrib0, w0c, num_segments=cap_words + 1, indices_are_sorted=True
    ) + jax.ops.segment_sum(
        contrib1, w1c, num_segments=cap_words + 1, indices_are_sorted=True
    )
    return words[:cap_words].astype(jnp.uint32), total_bits, dc[-1]


def build_entropy_luts(dc_luma, ac_luma, dc_chroma, ac_chroma) -> dict:
    """Stack per-table Huffman LUTs into (2, n) device arrays."""
    from ..codecs.jpeg.tables import huffman_lut

    dl_code, dl_len = huffman_lut(dc_luma, 16)
    dch_code, dch_len = huffman_lut(dc_chroma, 16)
    al_code, al_len = huffman_lut(ac_luma, 256)
    ach_code, ach_len = huffman_lut(ac_chroma, 256)
    return {
        "dc_code": jnp.asarray(np.stack([dl_code, dch_code]).astype(np.uint32)),
        "dc_len": jnp.asarray(np.stack([dl_len, dch_len]).astype(np.int32)),
        "ac_code": jnp.asarray(np.stack([al_code, ach_code]).astype(np.uint32)),
        "ac_len": jnp.asarray(np.stack([al_len, ach_len]).astype(np.int32)),
        "zrl_code": jnp.asarray(
            np.array([al_code[0xF0], ach_code[0xF0]], dtype=np.uint32)
        ),
        "zrl_len": jnp.asarray(np.array([al_len[0xF0], ach_len[0xF0]], dtype=np.int32)),
        "eob_code": jnp.asarray(
            np.array([al_code[0x00], ach_code[0x00]], dtype=np.uint32)
        ),
        "eob_len": jnp.asarray(np.array([al_len[0x00], ach_len[0x00]], dtype=np.int32)),
        # Packed (len<<16 | code) flat LUTs indexed by tsel*n + symbol.
        "dc_packed": jnp.asarray(
            (
                (np.stack([dl_len, dch_len]).astype(np.uint32) << 16)
                | np.stack([dl_code, dch_code]).astype(np.uint32)
            )[:, :16].reshape(-1)
        ),
        "ac_packed": jnp.asarray(
            (
                (np.stack([al_len, ach_len]).astype(np.uint32) << 16)
                | np.stack([al_code, ach_code]).astype(np.uint32)
            ).reshape(-1)
        ),
    }


def _symbol_streams(yb, cbb, crb, luts, prev_dc, sampling: str = "444"):
    """Shared symbol generation: (codes (B,65), lens (B,65), new_dc) where
    B = total blocks in MCU scan order (3 per MCU for 4:4:4, 6 — four Y +
    Cb + Cr — for 4:2:0).

    Column 0 = DC, columns 1..63 = AC positions, column 64 = EOB.
    """
    n = cbb.shape[0]  # MCU count
    per_mcu = (4, 1, 1) if sampling == "420" else (1, 1, 1)
    comps = (yb, cbb, crb)
    seq = jnp.concatenate(
        [c.reshape(n, k, 64) for c, k in zip(comps, per_mcu)], axis=1
    ).reshape(-1, 64).astype(jnp.int32)
    zz = _zz_permute(seq)
    tsel_pattern = [0] * per_mcu[0] + [1] * per_mcu[1] + [1] * per_mcu[2]
    tsel = jnp.tile(jnp.asarray(tsel_pattern, dtype=jnp.int32), n)

    # DC prediction is a per-component chain in that component's scan order
    # (T.81 F.1.1.5.1); compute each chain, then interleave to MCU order.
    diff_parts = []
    new_dc = []
    for ci, (c, k) in enumerate(zip(comps, per_mcu)):
        dc_c = c[:, 0].astype(jnp.int32)
        prev_c = jnp.concatenate([prev_dc[ci][None], dc_c[:-1]])
        diff_parts.append((dc_c - prev_c).reshape(n, k))
        new_dc.append(dc_c[-1])
    diffs = jnp.concatenate(diff_parts, axis=1).reshape(-1)
    dsz = _bit_size(diffs, 12)
    dval = jnp.where(diffs < 0, diffs + (1 << dsz) - 1, diffs) & ((1 << dsz) - 1)
    # Packed (len<<16 | code) LUT: one gather per symbol instead of two.
    dpacked = luts["dc_packed"][tsel * 16 + dsz]
    dcode = dpacked & jnp.uint32(0xFFFF)
    dlen = (dpacked >> 16).astype(jnp.int32)
    dc_codes = ((dcode << dsz) | dval.astype(jnp.uint32)).astype(jnp.uint32)
    dc_lens = (dlen + dsz).astype(jnp.int32)

    v = zz[:, 1:]
    nz = v != 0
    pos = jnp.broadcast_to(jnp.arange(1, 64, dtype=jnp.int32), v.shape)
    incl_cummax, prev_nz, last_nz = _prev_nonzero_scan(nz, pos)

    run = pos - prev_nz - 1
    asz = _bit_size(v, 11)
    aval = jnp.where(v < 0, v + (1 << asz) - 1, v) & ((1 << asz) - 1)
    sym = ((run % 16) << 4) | asz
    apacked = luts["ac_packed"][tsel[:, None] * 256 + sym]
    acode = apacked & jnp.uint32(0xFFFF)
    alen = (apacked >> 16).astype(jnp.int32)
    main_codes = ((acode << asz) | aval.astype(jnp.uint32)).astype(jnp.uint32)
    main_lens = jnp.where(nz, alen + asz, 0).astype(jnp.int32)

    zrl_here = (~nz) & ((pos - prev_nz) % 16 == 0) & (pos < last_nz[:, None])
    zrl_codes = jnp.broadcast_to(
        luts["zrl_code"][tsel][:, None], v.shape
    ).astype(jnp.uint32)
    zrl_lens = jnp.where(zrl_here, luts["zrl_len"][tsel][:, None], 0).astype(
        jnp.int32
    )
    ac_codes = jnp.where(nz, main_codes, zrl_codes)
    ac_lens = jnp.where(nz, main_lens, zrl_lens)

    need_eob = last_nz != 63
    eob_codes = luts["eob_code"][tsel].astype(jnp.uint32)
    eob_lens = jnp.where(need_eob, luts["eob_len"][tsel], 0).astype(jnp.int32)

    codes = jnp.concatenate(
        [dc_codes[:, None], ac_codes, eob_codes[:, None]], axis=1
    )
    lens = jnp.concatenate(
        [dc_lens[:, None], ac_lens, eob_lens[:, None]], axis=1
    )
    codes = jnp.where(lens > 0, codes, jnp.uint32(0))
    return codes, lens, jnp.stack(new_dc)


# Block-local word capacity for the scatter-free packer: 768 bits/block.
# Typical q85 blocks are 30-200 bits; overflow is detected and falls back.
LOCAL_WORDS = 24
# Blocks overlapping one 32-bit output word gathered per word. Typical
# blocks are >= 30 bits so 3 suffices almost always; the provable worst case
# (4-bit minimum blocks) is 9. The kernel computes the band's actual max
# overlap; if it exceeds K_OVERLAP the caller takes the exact host fallback.
K_OVERLAP = 4


def entropy_pack_trace_v2(
    yb, cbb, crb, luts, prev_dc, bit_base, cap_words: int,
    local_words: int = LOCAL_WORDS, sampling: str = "444",
):
    """Scatter-free entropy packing.

    This formulation uses only elementwise ops and gathers (no large
    scatter):

    1. *Block-local packing*: a 65-step loop (one step per symbol column)
       ORs each symbol's bits into a per-block (3N, local_words) buffer via
       one-hot word masks — elementwise work, no scatter.
    2. *Global merge*: block start bits come from a cumsum; every output
       word gathers the <=K_OVERLAP blocks overlapping it (searchsorted on
       the sorted block ends) and extracts its 32 bits from their local
       buffers with shifts. Disjoint bit ranges make OR == add unnecessary —
       plain bitwise OR accumulates.

    Returns (words (cap_words,) uint32, total_bits, new_dc,
    max_block_bits) — ``max_block_bits > local_words*32`` signals overflow
    (caller falls back to the host coder for the band).
    """
    codes, lens, new_dc = _symbol_streams(yb, cbb, crb, luts, prev_dc, sampling)
    nb = codes.shape[0]
    # The big block dimension is minor: state arrays are (small, nb),
    # symbol arrays (65, nb).
    codes_t = codes.T
    lens_t = lens.T

    # ---- Phase 1: per-block local packing --------------------------------
    lane = jnp.arange(local_words, dtype=jnp.int32)[:, None]  # (LW, 1)

    def step(s, state):
        local, off = state  # local: (LW, nb); off: (nb,)
        code = jax.lax.dynamic_index_in_dim(codes_t, s, axis=0, keepdims=False)
        ln = jax.lax.dynamic_index_in_dim(lens_t, s, axis=0, keepdims=False)
        end = off + ln
        w0 = off >> 5
        over = end - ((w0 + 1) << 5)
        in_one = over <= 0
        c32 = code.astype(jnp.uint32)
        contrib0 = jnp.where(
            in_one,
            c32 << jnp.clip(-over, 0, 31).astype(jnp.uint32),
            c32 >> jnp.clip(over, 0, 31).astype(jnp.uint32),
        )
        contrib1 = jnp.where(
            in_one,
            jnp.uint32(0),
            c32 << jnp.clip(32 - over, 0, 31).astype(jnp.uint32),
        )
        w1 = jnp.where(in_one, w0, w0 + 1)
        w0c = jnp.clip(w0, 0, local_words - 1)
        w1c = jnp.clip(w1, 0, local_words - 1)
        local = local | jnp.where(lane == w0c[None, :], contrib0[None, :], 0)
        local = local | jnp.where(lane == w1c[None, :], contrib1[None, :], 0)
        return local, end

    local = jnp.zeros((local_words, nb), dtype=jnp.uint32)
    off0 = jnp.zeros((nb,), dtype=jnp.int32)
    local, block_bits = jax.lax.fori_loop(0, codes_t.shape[0], step, (local, off0))
    max_block_bits = jnp.max(block_bits)

    # ---- Phase 2: gather-based global merge ------------------------------
    starts = bit_base.astype(jnp.int32) + jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(block_bits)[:-1]]
    )
    ends = starts + block_bits
    total_bits = ends[-1]

    word_ids = jnp.arange(cap_words, dtype=jnp.int32)
    word_start = word_ids << 5

    # First block whose end exceeds this word's start bit:
    # j_lo[w] = #{b : end_b <= 32w}. A per-word binary search would cost
    # ~log(nb) gathers per word; instead histogram the block-end words (one
    # small scatter-add) and take an exclusive cumulative sum.
    end_word = jnp.clip((ends - 1) >> 5, 0, cap_words - 1)
    counts = jax.ops.segment_sum(
        jnp.ones_like(end_word), end_word, num_segments=cap_words,
        indices_are_sorted=True,
    )
    j_lo = (jnp.cumsum(counts) - counts).astype(jnp.int32)

    # Actual per-word overlap: j_hi[w] = #{b : start_b < 32(w+1)} via the
    # same histogram trick; its max bounds the K loop (host fallback above).
    start_word = jnp.clip(starts >> 5, 0, cap_words - 1)
    start_counts = jax.ops.segment_sum(
        jnp.ones_like(start_word), start_word, num_segments=cap_words,
        indices_are_sorted=True,
    )
    j_hi = jnp.cumsum(start_counts).astype(jnp.int32)
    max_overlap = jnp.max(j_hi - j_lo)

    # The K rounds read starts[j_lo + k] for k = 0..K-1 — consecutive
    # indices, so one slice-K gather feeds every round (4 gathers -> 1).
    starts_pad = jnp.concatenate(
        [starts, jnp.full((K_OVERLAP,), jnp.iinfo(jnp.int32).max, jnp.int32)]
    )
    starts_k = jax.lax.gather(
        starts_pad,
        jnp.clip(j_lo, 0, nb - 1)[:, None],
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,)
        ),
        slice_sizes=(K_OVERLAP,),
        mode=jax.lax.GatherScatterMode.CLIP,
    )  # (cap_words, K_OVERLAP)

    # Transposed local + a zero pad column: the two words a block
    # contributes to one output word are adjacent, so one slice-2 gather
    # replaces the wA/wB pair (2 gathers -> 1). For li == -1 the slice
    # starts clipped at column 0, so pair[0] is local[0] == the needed wB.
    local_t = jnp.concatenate(
        [local.T, jnp.zeros((nb, 1), jnp.uint32)], axis=1
    )  # (nb, LW + 1)

    def gather_k(k):
        b = jnp.clip(j_lo + k, 0, nb - 1)
        # ends[b] > word_start holds by construction of j_lo (ends are
        # nondecreasing), so only the start-side bound needs a gather.
        s_b = starts_k[:, k]
        valid = (j_lo + k < nb) & (s_b < word_start + 32)
        rel = word_start - s_b  # may be negative; >= -31 wherever valid
        li = rel >> 5
        sh = (rel & 31).astype(jnp.uint32)
        pair = jax.lax.gather(
            local_t,
            jnp.stack([b, jnp.clip(li, 0, local_words - 1)], axis=-1),
            jax.lax.GatherDimensionNumbers(
                offset_dims=(1,), collapsed_slice_dims=(0,),
                start_index_map=(0, 1),
            ),
            slice_sizes=(1, 2),
            mode=jax.lax.GatherScatterMode.CLIP,
        )  # (cap_words, 2)
        wA = jnp.where(li >= 0, pair[:, 0], jnp.uint32(0))
        wB = jnp.where(li >= 0, pair[:, 1], pair[:, 0])
        ext = (wA << sh) | jnp.where(sh > 0, wB >> (jnp.uint32(32) - sh), 0)
        return jnp.where(valid, ext, jnp.uint32(0))

    # Unrolled (not fori_loop): the K extractions are independent until the
    # final OR, so XLA can overlap their gathers instead of serializing
    # through a loop-carried accumulator.
    words = functools.reduce(
        jnp.bitwise_or, [gather_k(k) for k in range(K_OVERLAP)]
    )
    return words, total_bits, new_dc, max_block_bits, max_overlap


def jpeg_encode_band_trace(
    band: jax.Array,  # (8k, W, 4) uint8, W % 8 == 0
    luma_q: jax.Array,
    chroma_q: jax.Array,
    luts: dict,
    prev_dc: jax.Array,  # (3,) int32 — device-resident carry
    bit_base: jax.Array,  # () int32 — device-resident carry
    cap_words: int,
    sampling: str = "444",
    local_words: int = LOCAL_WORDS,
):
    """The fully fused band program: YCbCr + DCT + quantize + entropy pack
    (scatter-free v2 packer). 4:4:4 or 4:2:0 (box-averaged chroma).

    One device dispatch per band; only the packed bitstream words (plus two
    scalars and the 3-vector DC carry) ever leave the device. The quantized
    blocks are additional outputs that are fetched *only* in the rare
    local-capacity-overflow fallback.
    """
    if sampling == "420":
        from .device import jpeg_quantize_420_trace as _quantize
    else:
        from .device import jpeg_quantize_trace as _quantize

    yb, cbb, crb = _quantize(band, luma_q, chroma_q)
    words, total_bits, new_dc, max_block_bits, max_overlap = entropy_pack_trace_v2(
        yb, cbb, crb, luts, prev_dc, bit_base, cap_words,
        local_words=local_words, sampling=sampling,
    )
    return words, total_bits, new_dc, max_block_bits, max_overlap, yb, cbb, crb


def _symbol_streams_flat(yb, cbb, crb, luts, n_groups: int,
                         sampling: str = "444"):
    """Group-flat symbol generation: like ``_symbol_streams`` but the DC
    prediction chains reset to 0 at every restart-group boundary (T.81
    E.2.4) while everything stays in ONE flat (nbt, 65) array — no vmap:
    the whole restart program works on globally flattened blocks.
    """
    n = cbb.shape[0]  # total MCUs
    per_mcu = (4, 1, 1) if sampling == "420" else (1, 1, 1)
    comps = (yb, cbb, crb)
    seq = jnp.concatenate(
        [c.reshape(n, k, 64) for c, k in zip(comps, per_mcu)], axis=1
    ).reshape(-1, 64).astype(jnp.int32)
    zz = _zz_permute(seq)
    tsel_pattern = [0] * per_mcu[0] + [1] * per_mcu[1] + [1] * per_mcu[2]
    tsel = jnp.tile(jnp.asarray(tsel_pattern, dtype=jnp.int32), n)

    # DC chains: per component, per group (reset to 0 at group starts).
    diff_parts = []
    for c, k in zip(comps, per_mcu):
        dc_c = c[:, 0].astype(jnp.int32).reshape(n_groups, -1)
        prev_c = jnp.pad(dc_c[:, :-1], ((0, 0), (1, 0)))
        diff_parts.append((dc_c - prev_c).reshape(n, k))
    diffs = jnp.concatenate(diff_parts, axis=1).reshape(-1)
    dsz = _bit_size(diffs, 12)
    dval = jnp.where(diffs < 0, diffs + (1 << dsz) - 1, diffs) & ((1 << dsz) - 1)
    dpacked = luts["dc_packed"][tsel * 16 + dsz]
    dcode = dpacked & jnp.uint32(0xFFFF)
    dlen = (dpacked >> 16).astype(jnp.int32)
    dc_codes = ((dcode << dsz) | dval.astype(jnp.uint32)).astype(jnp.uint32)
    dc_lens = (dlen + dsz).astype(jnp.int32)

    v = zz[:, 1:]
    nz = v != 0
    pos = jnp.broadcast_to(jnp.arange(1, 64, dtype=jnp.int32), v.shape)
    incl_cummax, prev_nz, last_nz = _prev_nonzero_scan(nz, pos)

    run = pos - prev_nz - 1
    asz = _bit_size(v, 11)
    aval = jnp.where(v < 0, v + (1 << asz) - 1, v) & ((1 << asz) - 1)
    sym = ((run % 16) << 4) | asz
    apacked = luts["ac_packed"][tsel[:, None] * 256 + sym]
    acode = apacked & jnp.uint32(0xFFFF)
    alen = (apacked >> 16).astype(jnp.int32)
    main_codes = ((acode << asz) | aval.astype(jnp.uint32)).astype(jnp.uint32)
    main_lens = jnp.where(nz, alen + asz, 0).astype(jnp.int32)

    zrl_here = (~nz) & ((pos - prev_nz) % 16 == 0) & (pos < last_nz[:, None])
    zrl_codes = jnp.broadcast_to(
        luts["zrl_code"][tsel][:, None], v.shape
    ).astype(jnp.uint32)
    zrl_lens = jnp.where(zrl_here, luts["zrl_len"][tsel][:, None], 0).astype(
        jnp.int32
    )
    ac_codes = jnp.where(nz, main_codes, zrl_codes)
    ac_lens = jnp.where(nz, main_lens, zrl_lens)

    need_eob = last_nz != 63
    eob_codes = luts["eob_code"][tsel].astype(jnp.uint32)
    eob_lens = jnp.where(need_eob, luts["eob_len"][tsel], 0).astype(jnp.int32)

    codes = jnp.concatenate(
        [dc_codes[:, None], ac_codes, eob_codes[:, None]], axis=1
    )
    lens = jnp.concatenate(
        [dc_lens[:, None], ac_lens, eob_lens[:, None]], axis=1
    )
    codes = jnp.where(lens > 0, codes, jnp.uint32(0))
    return codes, lens


def _pack_blocks_aligned(codes, lens, starts, local_words: int,
                         transpose: bool = True):
    """Phase 1, pre-aligned: pack each block's symbols into a per-block
    word buffer already bit-aligned to the block's GLOBAL start.

    The per-block packing loop places each symbol at a dynamic offset
    anyway, so starting the offset at ``starts & 31`` instead of 0 costs
    nothing — and it deletes all shift work from the merge: the merge
    then only ORs whole words. Buffer is local_words + 2 words: the
    block-bit budget (local_words*32) plus up to 31 alignment bits.

    Symbols are consumed in PAIRS: a pair is the bit-concatenation
    ``V = code1·2^len2 + code2`` (≤ 56 bits: DC ≤ 16+12, AC ≤ 16+11),
    placed in one step as a 3-word contribution. That halves the
    sequential fori_loop chain (65 → 33 steps) and the whole-buffer OR
    traffic per step relative to one-symbol-at-a-time packing, which is
    where most of phase 1's time went (each step reads+writes the whole
    (AW, nb) buffer; the per-lane math is trivial).

    V is carried as a 24+32-bit (hi, lo) uint32 pair and shifted to its word alignment as a 3-word (hi, mid, lo)
    window: with sh = left-shift to align V's LSB to the end word's bit
    boundary, word wE gets (V<<sh) mod 2^32, wE-1 the next 32 bits, wE-2
    the top bits. Words below the pair's first word receive zeros (the
    shifted value has no bits there), so clipped lane indices are inert.

    Returns aligned (nb, local_words + 2) uint32.
    """
    nb = codes.shape[0]
    n_aw = local_words + 2
    n_sym = codes.shape[1]
    if n_sym % 2:
        # Pad to an even symbol count; zero-length symbols are inert.
        codes = jnp.pad(codes, ((0, 0), (0, 1)))
        lens = jnp.pad(lens, ((0, 0), (0, 1)))
        n_sym += 1
    # (n_pairs, 2, nb): one dynamic row-index pulls a whole pair.
    codes_p = codes.T.reshape(n_sym // 2, 2, nb)
    lens_p = lens.T.reshape(n_sym // 2, 2, nb)
    lane = jnp.arange(n_aw, dtype=jnp.int32)[:, None]  # (AW, 1)

    def step(s, state):
        local, off = state  # local: (AW, nb); off: (nb,) bit offsets
        pair_c = jax.lax.dynamic_index_in_dim(codes_p, s, axis=0, keepdims=False)
        pair_l = jax.lax.dynamic_index_in_dim(lens_p, s, axis=0, keepdims=False)
        c1, c2 = pair_c[0], pair_c[1]
        l1, l2 = pair_l[0], pair_l[1]
        tl = l1 + l2
        # V = c1·2^l2 | c2 as (hi ≤ 24 bits, lo 32 bits). l2 ≤ 28 < 32 so
        # the in-word shift is legal; l2 == 0 needs the where (c1 >> 32 is
        # undefined), and c2 < 2^l2 guarantees no carries into hi.
        l2u = l2.astype(jnp.uint32)
        v_lo = (c1 << l2u) | c2
        v_hi = jnp.where(
            l2 == 0,
            jnp.uint32(0),
            c1 >> jnp.clip(32 - l2, 0, 31).astype(jnp.uint32),
        )
        end = off + tl
        # Left-shift aligning V's LSB with the end of word wE.
        sh = ((32 - (end & 31)) & 31).astype(jnp.uint32)
        inv = jnp.clip(32 - sh.astype(jnp.int32), 0, 31).astype(jnp.uint32)
        lo_spill = jnp.where(sh == 0, jnp.uint32(0), v_lo >> inv)
        hi_spill = jnp.where(sh == 0, jnp.uint32(0), v_hi >> inv)
        d_lo = v_lo << sh
        d_mid = (v_hi << sh) | lo_spill
        d_hi = hi_spill
        w_e = (end - 1) >> 5  # -1 only when off == 0 and tl == 0 (V == 0)
        w0c = jnp.clip(w_e, 0, n_aw - 1)
        w1c = jnp.clip(w_e - 1, 0, n_aw - 1)
        w2c = jnp.clip(w_e - 2, 0, n_aw - 1)
        local = local | (
            jnp.where(lane == w0c[None, :], d_lo[None, :], 0)
            | jnp.where(lane == w1c[None, :], d_mid[None, :], 0)
            | jnp.where(lane == w2c[None, :], d_hi[None, :], 0)
        )
        return local, end

    local = jnp.zeros((n_aw, nb), dtype=jnp.uint32)
    off0 = (starts & 31).astype(jnp.int32)
    local, _ = jax.lax.fori_loop(0, n_sym // 2, step, (local, off0))
    if not transpose:
        return local  # (AW, nb) — the segsum merge's native layout
    return local.T  # (nb, AW)


def _pack_dispatch(codes, lens, starts, local_words: int,
                   transpose: bool = True, mesh=None):
    """Phase-1 packing: the Pallas kernel
    (ops/pallas_kernels.pack_blocks_aligned_pallas, Triton) on a GPU, the
    XLA form _pack_blocks_aligned elsewhere; the two are bit-identical.

    Blocks pack independently, so with a ``mesh`` each device packs its
    own contiguous share of the blocks under ``shard_map`` (a Triton call
    is opaque to the SPMD partitioner, which would otherwise run it whole
    on every device)."""
    if jax.default_backend() == "gpu":
        from .pallas_kernels import pack_blocks_aligned_pallas

        def pack(c, n, s):
            return pack_blocks_aligned_pallas(c, n, s, local_words)
    else:
        def pack(c, n, s):
            return _pack_blocks_aligned(c, n, s, local_words, transpose=False)

    if mesh is not None and codes.shape[0] % mesh.size == 0:
        from jax.sharding import PartitionSpec as P

        blocks = P(tuple(mesh.axis_names))
        pack = jax.shard_map(
            pack, mesh=mesh, in_specs=(blocks, blocks, blocks),
            out_specs=P(None, tuple(mesh.axis_names)), check_vma=False,
        )
    local = pack(codes, lens, starts)
    return local.T if transpose else local


def _merge_aligned(aligned, starts, block_bits, cap_words: int,
                   k_overlap: int = K_OVERLAP):
    """Phase 2, flat: OR pre-aligned per-block buffers into the global
    word stream with K full-row gathers.

    Flat arrays and whole-row slices, with a masked column select instead
    of a second gather dimension.

    aligned: (nb, AW) uint32 pre-aligned buffers; starts/block_bits in
    bits, ``starts`` strictly nondecreasing. Returns (words (cap_words,)
    uint32, max_overlap).
    """
    nb, n_aw = aligned.shape
    ends = starts + block_bits
    word_ids = jnp.arange(cap_words, dtype=jnp.int32)

    # j_lo[w] = #{b : end_b <= 32w} — histogram + exclusive cumsum
    # (_rank_sorted; a binary search per word would be ~log(nb) gathers
    # each).
    end_word = jnp.clip((ends - 1) >> 5, 0, cap_words - 1)
    j_lo = _rank_sorted(end_word, cap_words, inclusive=False)
    start_word = jnp.clip(starts >> 5, 0, cap_words - 1)
    j_hi = _rank_sorted(start_word, cap_words, inclusive=True)
    max_overlap = jnp.max(j_hi - j_lo)

    # Record rows: [wstart | aligned words]. K sentinel rows (wstart = INT
    # MAX) make out-of-range j_lo + k reads invalid via the wstart test.
    wstart = (starts >> 5).astype(jnp.int32)
    rec = jnp.concatenate(
        [
            jnp.concatenate(
                [wstart[:, None].astype(jnp.uint32), aligned], axis=1
            ),
            # Sentinel wstart must stay POSITIVE as int32 (0x7FFFFFFF):
            # 0xFFFFFFFF casts to -1 and passes the ws <= word test,
            # leaking sentinel bits into unused tail words.
            jnp.full((k_overlap, n_aw + 1), 0x7FFFFFFF, jnp.uint32),
        ],
        axis=0,
    )  # (nb + K, AW + 1)

    dn_row = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,), start_index_map=(0,)
    )

    def gather_k(k):
        rows = jax.lax.gather(
            rec, (j_lo + k)[:, None], dn_row, slice_sizes=(1, n_aw + 1),
            mode=jax.lax.GatherScatterMode.CLIP,
        )  # (cap_words, AW + 1)
        ws = rows[:, 0].astype(jnp.int32)
        rel = word_ids - ws  # block's word containing this output word
        valid = (ws <= word_ids) & (rel < n_aw)
        # 2D masked OR-reduction over the AW columns: the data stays 2D
        # until one OR along the minor dim. Words past the block's end are
        # zero in `aligned` already.
        mask = rel[:, None] == jnp.arange(n_aw, dtype=jnp.int32)[None, :]
        val2d = jnp.where(mask, rows[:, 1:], jnp.uint32(0))
        val = jax.lax.reduce(val2d, jnp.uint32(0), jax.lax.bitwise_or, (1,))
        return jnp.where(valid, val, jnp.uint32(0))

    words = functools.reduce(
        jnp.bitwise_or, [gather_k(k) for k in range(k_overlap)]
    )
    return words, max_overlap


def _rank_sorted(idx, cap_words: int, inclusive: bool):
    """rank[w] = #{b : idx[b] < w} (or <= w when ``inclusive``) for
    sorted int32 ``idx``, w in [0, cap_words): the exclusive (inclusive)
    cumsum of the histogram of ``idx``."""
    counts = jax.ops.segment_sum(
        jnp.ones_like(idx), idx, num_segments=cap_words,
        indices_are_sorted=True,
    )
    csum = jnp.cumsum(counts)
    return (csum if inclusive else csum - counts).astype(jnp.int32)


def _merge_aligned_hybrid(local, starts, block_bits, cap_words: int):
    """Phase 2 as one gather round + one sorted scatter-add.

    Blocks tile the bit space contiguously (each start is the previous
    end), so the contributors to output word w are exactly: the unique
    COVERER (the block containing bit 32w — the first block whose end
    exceeds it, j_lo[w]), whose pre-aligned buffer holds every word it
    covers at column w - wstart; plus STARTERS — blocks whose start bit
    lies inside word w — which contribute only their column-0 word.
    Hence: one full-row gather (the coverer) OR one segment_sum of
    ``local[0]`` keyed by start word (starter bits are mutually disjoint,
    so ADD == OR; a word-aligned coverer appears in both pools with the
    identical value, and OR is idempotent).

    Unlike the K-round gather merge there is NO per-word overlap bound:
    any number of tiny blocks per word is exact by construction. Work is
    cap_words gather rows + nb scatter elements, vs cap_words * K rows.

    ``local`` is phase 1's native (AW, nb) layout. Returns (cap_words,)
    uint32.
    """
    n_aw, nb = local.shape
    ends = starts + block_bits
    word_ids = jnp.arange(cap_words, dtype=jnp.int32)
    end_word = jnp.clip((ends - 1) >> 5, 0, cap_words - 1)
    j_lo = _rank_sorted(end_word, cap_words, inclusive=False)

    wstart = (starts >> 5).astype(jnp.int32)
    rec = jnp.concatenate(
        [
            jnp.concatenate(
                [wstart[:, None].astype(jnp.uint32), local.T], axis=1
            ),
            jnp.full((1, n_aw + 1), 0x7FFFFFFF, jnp.uint32),  # int32-positive
        ],
        axis=0,
    )  # (nb + 1, AW + 1)
    dn_row = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,), start_index_map=(0,)
    )
    rows = jax.lax.gather(
        rec, j_lo[:, None], dn_row, slice_sizes=(1, n_aw + 1),
        mode=jax.lax.GatherScatterMode.CLIP,
    )  # (cap_words, AW + 1)
    ws = rows[:, 0].astype(jnp.int32)
    rel = word_ids - ws
    valid = (ws <= word_ids) & (rel < n_aw)
    mask = rel[:, None] == jnp.arange(n_aw, dtype=jnp.int32)[None, :]
    val2d = jnp.where(mask, rows[:, 1:], jnp.uint32(0))
    cover = jax.lax.reduce(val2d, jnp.uint32(0), jax.lax.bitwise_or, (1,))
    cover = jnp.where(valid, cover, jnp.uint32(0))

    starters = jax.ops.segment_sum(
        local[0], wstart, num_segments=cap_words, indices_are_sorted=True,
    )
    return cover | starters


def _merge_aligned_segsum(local, starts, cap_words: int):
    """Phase 2 via sorted scatter-add: OR == ADD on bit-disjoint words.

    ``local`` is phase 1's native (AW, nb) layout (UNtransposed — row
    slices of the lane-major array are the fast path; column slices of a
    transposed copy cost a lane extraction each). Block b's aligned word
    c belongs at global word ``(starts[b] >> 5) + c``; every set bit of
    the output stream comes from exactly one (block, column) pair, so
    summing contributions can never carry and equals the bitwise OR.
    One sorted ``segment_sum`` per AW column replaces the K_OVERLAP
    full-row gather rounds over the whole cap_words output — work scales
    with nb (blocks), not with the allocated output capacity, and no
    per-word overlap bound exists (tiny-block flat content that would
    overflow K_OVERLAP in the gather merge just works).

    Returns (words (cap_words,) uint32).
    """
    n_aw, nb = local.shape
    wstart = (starts >> 5).astype(jnp.int32)
    words = jnp.zeros((cap_words,), jnp.uint32)
    for c in range(n_aw):
        # Indices >= cap_words are dropped by segment_sum (scatter drop
        # semantics); in-range per-column index vectors stay sorted
        # because starts is nondecreasing.
        words = words + jax.ops.segment_sum(
            local[c], wstart + c, num_segments=cap_words,
            indices_are_sorted=True,
        )
    return words


def jpeg_encode_band_groups_trace(
    band: jax.Array,  # (8k, W, 4) uint8, W % 8 == 0
    luma_q: jax.Array,
    chroma_q: jax.Array,
    luts: dict,
    n_groups: int,
    cap_words: int,  # per group
    sampling: str = "444",
    local_words: int = LOCAL_WORDS,
    merge: str = "gather",
    k_overlap: int = K_OVERLAP,
    mesh=None,
):
    """Fused band program for restart-interval mode: quantize once, then
    pack every restart group in one FLAT program (prev_dc = 0 and
    bit_base = 0 per group — T.81 E.2.4 restart semantics).

    The groups' streams are laid out densely: group g's words start at the
    dense word offset cumsum(ceil(bits/32))[g], exactly the layout the
    host fetch expects, so there is no separate repack stage. Placing each
    group at a 32-aligned dense base keeps the global ``starts`` monotone,
    which is what lets one flat merge handle every group at once.

    Capacity is pooled: the band overflows only when the TOTAL dense words
    exceed n_groups * cap_words (per-group spikes borrow from the pool).
    The host detects that from the per-group bit counts it fetches anyway
    (sum(ceil(bits/32)) > n_groups*cap_words) — plus the per-block
    local_words budget via max_block_bits as before.

    Groups are byte-aligned in the output stream, so there is no inter-band
    bit carry at all; the host pads each group's tail byte with 1s, stuffs,
    and joins groups with RSTn markers.
    """
    if sampling == "420":
        from .device import jpeg_quantize_420_trace as _quantize
    else:
        from .device import jpeg_quantize_trace as _quantize

    yb, cbb, crb = _quantize(band, luma_q, chroma_q)
    dense, group_bits, max_block_bits, max_overlap = (
        jpeg_pack_groups_from_blocks_trace(
            yb, cbb, crb, luts, n_groups, cap_words,
            sampling=sampling, local_words=local_words, merge=merge,
            k_overlap=k_overlap, mesh=mesh,
        )
    )
    return dense, group_bits, max_block_bits, max_overlap, yb, cbb, crb


def jpeg_pack_groups_from_blocks_trace(
    yb, cbb, crb,
    luts: dict,
    n_groups: int,
    cap_words: int,  # per group
    sampling: str = "444",
    local_words: int = LOCAL_WORDS,
    merge: str = "gather",
    k_overlap: int = K_OVERLAP,
    mesh=None,
):
    """Entropy-pack already-quantized blocks as restart groups.

    The quantize-less core of ``jpeg_encode_band_groups_trace``; also
    dispatched standalone for the on-device overflow RE-PACK: when a
    band's first pack overflows a budget (per-word overlap > K_OVERLAP on
    tiny-block flat content, pooled word capacity, or the per-block
    local_words budget), the encoder re-dispatches just this program on
    the device-resident quantized blocks with corrected parameters
    (merge="segsum" / exact capacity / bigger budget) instead of
    host-coding — the blocks never leave the device, and the bytes are
    identical by construction (the merge strategies are bit-equivalent;
    capacity only sizes the output buffer). ``mesh``: the mesh the
    program is sharded over, if any (see _pack_dispatch).
    """
    codes, lens = _symbol_streams_flat(yb, cbb, crb, luts, n_groups, sampling)

    block_bits = jnp.sum(lens, axis=1)  # (nbt,)
    max_block_bits = jnp.max(block_bits)
    nb_g = block_bits.shape[0] // n_groups
    per_group = block_bits.reshape(n_groups, nb_g)
    group_bits = jnp.sum(per_group, axis=1)  # (n_groups,)
    used = (group_bits + 31) >> 5
    dense_base = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(used)[:-1]]
    )  # word offset of each group in the dense stream
    in_group = jnp.cumsum(per_group, axis=1) - per_group  # exclusive
    starts = (
        (dense_base[:, None] << 5) + in_group
    ).reshape(-1).astype(jnp.int32)

    total = n_groups * cap_words
    if merge == "hybrid":
        local = _pack_dispatch(
            codes, lens, starts, local_words, transpose=False, mesh=mesh
        )
        dense = _merge_aligned_hybrid(local, starts, block_bits, total)
        # Exact for any per-word overlap; 0 keeps the host check inert.
        max_overlap = jnp.int32(0)
    elif merge == "segsum":
        local = _pack_dispatch(
            codes, lens, starts, local_words, transpose=False, mesh=mesh
        )
        dense = _merge_aligned_segsum(local, starts, total)
        # No per-word overlap bound exists in the scatter-add merge; emit
        # a constant 0 so the host-side K_OVERLAP check is inert.
        max_overlap = jnp.int32(0)
    else:
        aligned = _pack_dispatch(codes, lens, starts, local_words, mesh=mesh)
        dense, max_overlap = _merge_aligned(
            aligned, starts, block_bits, total, k_overlap=k_overlap
        )
    return dense, group_bits, max_block_bits, max_overlap


@functools.lru_cache(maxsize=None)
def _groups_trace_on(mesh):
    """jpeg_encode_band_groups_trace bound to ``mesh``: one function object
    per mesh, so every encoder on it shares jit's trace cache (a fresh
    partial per encoder would re-trace each run)."""
    return functools.partial(jpeg_encode_band_groups_trace, mesh=mesh)


class DeviceJpegEncoder:
    """Streaming fused device encoder with device-resident carry chain.

    ``submit`` dispatches the fused program for a band, threading prev_dc and
    the bit offset through *device* arrays so consecutive submissions never
    synchronize with the host; ``wait`` fetches the packed words and applies
    stuffing + the sub-byte carry. One-band lookahead happens in the caller.

    With ``restart_interval_rows`` > 0 the band is packed as independent
    restart groups (see jpeg_encode_band_groups_trace); the caller must
    submit group-aligned bands (a final shorter group only at the end).
    """

    def __init__(self, luma_q, chroma_q, dc_luma, ac_luma, dc_chroma, ac_chroma,
                 cap_bits_per_px: int = DEFAULT_CAP_BITS_PER_PX,
                 restart_interval_rows: int = 0, mcus_per_row: int | None = None,
                 mesh=None, sampling: str = "444",
                 local_words: int = LOCAL_WORDS, batch_bands: int = 1):
        # local_words bounds the per-block bit budget (local_words*32); the
        # phase-2 merge gathers from a (nb, local_words+1) array, so a
        # tighter budget shrinks its working set. Blocks that exceed it take
        # the exact host fallback — callers pick by quality (q85 blocks max
        # ~330 bits even on uniform noise).
        self._local_words = int(local_words)
        self._lq = jnp.asarray(luma_q)
        self._cq = jnp.asarray(chroma_q)
        self._luts = build_entropy_luts(dc_luma, ac_luma, dc_chroma, ac_chroma)
        self._host_tables = (dc_luma, ac_luma, dc_chroma, ac_chroma)
        self._prev_dc = jnp.zeros(3, dtype=jnp.int32)
        self._bit_base = jnp.int32(0)
        self._carry_val = 0  # host-side partial-byte value (bits = bit_base)
        self._cap_bits_per_px = cap_bits_per_px
        self._jit = jax.jit(
            jpeg_encode_band_trace,
            static_argnames=("cap_words", "sampling", "local_words"),
        )
        self._restart_rows = int(restart_interval_rows)
        self._mcus_per_row = mcus_per_row
        self._groups_emitted = 0
        self._rst_n = 0
        # Batch-N dispatch (restart mode only): group-aligned bands
        # accumulate device-resident and dispatch as ONE flat program.
        # Restart groups carry no inter-band state, so N stacked bands are
        # just N x n_groups independent groups in one dispatch — the
        # per-dispatch fixed costs amortize over the batch.
        self._batch_bands = max(1, int(batch_bands))
        self._batch_pending: list = []
        self._mesh = mesh
        self._sampling = sampling
        self._mcu_px = 16 if sampling == "420" else 8
        self._jit_groups_plain = jax.jit(
            jpeg_encode_band_groups_trace,
            static_argnames=(
                "n_groups", "cap_words", "sampling", "local_words", "merge",
            ),
        )
        # Merge strategy: hybrid (one coverer gather round + a sorted
        # scatter-add of starter words) is exact for ANY per-word overlap
        # — no K_OVERLAP bound, so flat content never re-packs.
        # gather/segsum remain selectable; overflow re-packs may still go
        # sticky-segsum (equally unbounded).
        self._merge_mode = "hybrid"
        # Observed max group bits/px of recent bands drives the capacity
        # budget for the next submit (the merge scans the whole allocated
        # output, so a tight budget is a first-order device-time lever;
        # mispredictions cost one on-device re-pack, not a host fallback).
        self._cap_recent = collections.deque(maxlen=4)
        self._jit_pack = jax.jit(
            jpeg_pack_groups_from_blocks_trace,
            static_argnames=(
                "n_groups", "cap_words", "sampling", "local_words", "merge"
            ),
        )
        if mesh is not None:
            # Restart groups are row slabs: sharding band rows over 'band'
            # distributes whole groups across devices; each packs its own
            # byte-aligned bitstream with zero cross-device carry.
            from jax.sharding import NamedSharding, PartitionSpec as P

            band3d = NamedSharding(mesh, P("band", "x", None))
            rep = NamedSharding(mesh, P())
            lut_shardings = {k: rep for k in self._luts}
            sharded_trace = _groups_trace_on(mesh)
            self._jit_groups = jax.jit(
                sharded_trace,
                static_argnames=(
                    "n_groups", "cap_words", "sampling", "local_words",
                    "merge",
                ),
                in_shardings=(band3d, rep, rep, lut_shardings),
            )
            # Packed uint32 bands are rank-2: same row/column sharding,
            # no channel axis.
            self._jit_groups_packed = jax.jit(
                sharded_trace,
                static_argnames=(
                    "n_groups", "cap_words", "sampling", "local_words",
                    "merge",
                ),
                in_shardings=(
                    NamedSharding(mesh, P("band", "x")), rep, rep,
                    lut_shardings,
                ),
            )
        else:
            self._jit_groups = self._jit_groups_plain
            self._jit_groups_packed = self._jit_groups_plain

    def _groups_jit_for(self, shape) -> object:
        """Sharded jit when the (rows, width) divide the mesh; plain
        otherwise (indivisible tails, e.g. the final partial group)."""
        if self._mesh is None:
            return self._jit_groups
        if shape[0] % self._mesh.shape["band"] or shape[1] % self._mesh.shape["x"]:
            return self._jit_groups_plain
        if len(shape) == 2:
            return self._jit_groups_packed
        return self._jit_groups

    @staticmethod
    def _strip_alpha(band):
        """JPEG ignores alpha; uploading (H, W, 3) cuts transfer bytes 25%
        (the traces only read channels 0..2 so the programs are unchanged
        modulo the input shape). Rank-2 bands are byte-packed uint32 RGBA
        (device-resident, never uploaded) — passed through; ycbcr_int
        unpacks them arithmetically."""
        if band.ndim == 3 and band.shape[-1] == 4:
            if isinstance(band, np.ndarray):
                return np.ascontiguousarray(band[..., :3])
            return band[..., :3]
        return band

    def submit(self, band: np.ndarray):
        band = self._strip_alpha(band)
        if band.ndim == 2 and self._batch_bands > 1:
            # Batched dispatch concatenates accumulated bands: normalize
            # packed uint32 bands to the (H, W, 3) form so a mixed
            # packed/interleaved stream can share one batch (bitcast is
            # byte-identical by the little-endian pack contract).
            band = jax.lax.bitcast_convert_type(
                jnp.asarray(band), jnp.uint8
            )[..., :3]
        if self._restart_rows:
            return self._submit_groups(band)
        band = jnp.asarray(band)
        prev_dc_in = self._prev_dc
        bit_base_in = self._bit_base
        n_pixels = band.shape[0] * band.shape[1]
        cap_words = max(64, (n_pixels * self._cap_bits_per_px + 31) // 32)
        from .program_cache import note_program

        note_program(
            "jpeg_band", tuple(band.shape), cap_words, self._sampling,
            self._local_words,
        )
        words, total_bits, new_dc, max_bb, max_ov, yb, cbb, crb = self._jit(
            band,
            self._lq,
            self._cq,
            self._luts,
            prev_dc_in,
            bit_base_in,
            cap_words=cap_words,
            sampling=self._sampling,
            local_words=self._local_words,
        )
        count("device_jpeg_programs")
        # Thread the carry on-device; no host synchronization here.
        self._prev_dc = new_dc
        self._bit_base = (total_bits % 8).astype(jnp.int32)
        try:
            total_bits.copy_to_host_async()
            max_bb.copy_to_host_async()
            max_ov.copy_to_host_async()
        except AttributeError:  # pragma: no cover
            pass
        return (
            words, total_bits, cap_words, max_bb, max_ov, (yb, cbb, crb),
            prev_dc_in, bit_base_in,
        )

    # Capacity buckets for the adaptive per-group budget (bits/px). A
    # bucketed ladder bounds the number of distinct compiled executables
    # per band shape while letting quiet content run the merge at ~half
    # the default capacity (merge work scales with allocated words).
    _CAP_BUCKETS = (1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 6.0, 8.0, 12.0)

    def _group_cap_bits_px(self) -> float:
        """Current per-group capacity budget in bits/px: observed recent
        peak * 1.15 headroom, bucketed; the configured value until the
        first band reports. Underestimates cost one on-device re-pack,
        so the headroom stays thin (bench-like content at 2.05 bits/px
        must land in the 2.5 bucket, not bounce back to 3.0)."""
        if not self._cap_recent:
            return float(self._cap_bits_per_px)
        want = max(self._cap_recent) * 1.15
        for b in self._CAP_BUCKETS:
            if b >= want:
                return min(b, float(MAX_CAP_BITS_PER_PX))
        return float(MAX_CAP_BITS_PER_PX)

    def _submit_groups(self, band: np.ndarray):
        """Restart-group dispatch: the band must hold whole ri-row groups,
        except a single final shorter group (tail of the image).

        With ``batch_bands > 1`` group-aligned bands accumulate (device-
        resident; uploads overlap accumulation) and dispatch as one flat
        program when the batch fills or a tail arrives. Returns ``None``
        when the call only accumulated — the caller must drain via
        ``flush_pending()`` at end of stream."""
        ri = self._restart_rows
        mcu_px = self._mcu_px
        band = jnp.asarray(band)
        mcu_rows = band.shape[0] // mcu_px
        tail_rows = mcu_rows % ri
        handles = []
        if mcu_rows - tail_rows:
            self._batch_pending.append(band[: (mcu_rows - tail_rows) * mcu_px])
            if len(self._batch_pending) >= self._batch_bands:
                handles += self._dispatch_pending()
        if tail_rows:
            # Any accumulating batch must dispatch BEFORE the tail: wait()
            # emits handles in order, and the tail is later in the stream
            # (a tail-only submit — finish() of a group-aligned stream plus
            # a padded partial strip — would otherwise emit its group ahead
            # of the batched mains).
            handles += self._dispatch_pending()
            tail = band[(mcu_rows - tail_rows) * mcu_px :]
            px = tail_rows * mcu_px * band.shape[1]
            cap_bits_px = self._group_cap_bits_px()
            cap_words = max(64, (int(px * cap_bits_px) + 31) // 32)
            from .program_cache import note_program

            note_program(
                "jpeg_groups", tuple(tail.shape), 1, cap_words,
                self._sampling, self._local_words, self._merge_mode,
            )
            out = self._groups_jit_for(tail.shape)(
                tail, self._lq, self._cq, self._luts, 1, cap_words,
                self._sampling, self._local_words,
                self._merge_mode,
            )
            count("device_jpeg_programs")
            self._async_copy(out)
            handles.append((out, 1, cap_words, px))
        if not handles:
            return None
        return ("groups", handles)

    def _dispatch_pending(self) -> list:
        """Dispatch the accumulated group-aligned bands as one program."""
        if not self._batch_pending:
            return []
        if len(self._batch_pending) == 1:
            main = self._batch_pending[0]
        else:
            main = jnp.concatenate(self._batch_pending, axis=0)
        self._batch_pending = []
        ri = self._restart_rows
        mcu_px = self._mcu_px
        n_groups = (main.shape[0] // mcu_px) // ri
        px_per_group = ri * mcu_px * main.shape[1]
        cap_bits_px = self._group_cap_bits_px()
        cap_words = max(64, (int(px_per_group * cap_bits_px) + 31) // 32)
        from .program_cache import note_program

        note_program(
            "jpeg_groups", tuple(main.shape), n_groups, cap_words,
            self._sampling, self._local_words, self._merge_mode,
        )
        jit_g = self._groups_jit_for(main.shape)
        if (
            jit_g in (self._jit_groups, self._jit_groups_packed)
            and self._mesh is not None
        ):
            # Committed device arrays (fused positioned/decode handoff)
            # must match the sharded jit's in_sharding — reshard lazily.
            from jax.sharding import NamedSharding, PartitionSpec as P

            spec = P("band", "x") if main.ndim == 2 else P("band", "x", None)
            main = jax.device_put(main, NamedSharding(self._mesh, spec))
        out = jit_g(
            main, self._lq, self._cq, self._luts, n_groups, cap_words,
            self._sampling, self._local_words,
            self._merge_mode,
        )
        count("device_jpeg_programs")
        self._async_copy(out)
        return [(out, n_groups, cap_words, px_per_group)]

    def flush_pending(self):
        """Dispatch any batched bands still accumulating (end of stream).
        Returns a ``wait()``-able handle or None."""
        handles = self._dispatch_pending()
        return ("groups", handles) if handles else None

    @staticmethod
    def _async_copy(out) -> None:
        # Only the small control outputs (bits, overflow scalars) prefetch;
        # the dense word stream transfers lazily so the host can fetch just
        # the used prefix (bucketed slice) instead of the padded buffer.
        try:
            for a in out[1:4]:
                a.copy_to_host_async()
        except AttributeError:  # pragma: no cover
            pass

    def _rst_marker(self) -> bytes:
        m = bytes([0xFF, 0xD0 + self._rst_n])
        self._rst_n = (self._rst_n + 1) & 7
        return m

    # Host-side fetch bucket for the dense word stream (bounds the number
    # of distinct slice shapes the fetch compiles).
    _FETCH_BUCKET_WORDS = 8192

    def _repack_on_device(self, blocks, bits_h, max_bb: int, n_groups: int,
                          budget_over: bool, overlap_over: bool):
        """Re-pack an overflowed band on-device from its already-resident
        quantized blocks (no quantize re-run, nothing leaves the device).

        The first pack's per-group bit counts are exact regardless of which
        budget overflowed (symbol lengths don't depend on packing), so the
        corrected parameters are known precisely: the pooled capacity from
        the counts, the block budget from max_bb, and the merge strategy
        (scatter-add has no per-word overlap bound — see
        _merge_aligned_segsum). Returns (dense, cap_words), or None when
        the content exceeds every device budget (caller host-codes).
        """
        local_words = self._local_words
        if budget_over:
            for cand in (12, 16, LOCAL_WORDS):
                if cand > local_words and max_bb <= cand * 32:
                    local_words = cand
                    break
            if max_bb > local_words * 32:
                return None
            # Adopt the bigger budget for subsequent bands (sticky, like
            # the merge mode: content proved the tighter budget wrong).
            self._local_words = local_words
        if overlap_over:
            self._merge_mode = "segsum"
        count("device_jpeg_repacks")
        used = (bits_h + 31) // 32
        need_per_group = -(-int(used.sum()) // n_groups)
        cap_words = max(64, -(-need_per_group // 256) * 256)
        from .program_cache import note_program

        note_program(
            "jpeg_repack", tuple(blocks[0].shape), n_groups, cap_words,
            self._sampling, local_words, self._merge_mode,
        )
        dense, bits2, max_bb2, max_ov2 = self._jit_pack(
            *blocks, self._luts, n_groups=n_groups, cap_words=cap_words,
            sampling=self._sampling, local_words=local_words,
            merge=self._merge_mode,
        )
        if self._merge_mode == "gather" and int(max_ov2) > K_OVERLAP:
            # The first pack's overlap scalar is clipped garbage when the
            # pooled capacity overflowed, so the true overlap shows up
            # only now; switch to the unbounded merge and go again.
            self._merge_mode = "segsum"
            dense, bits2, max_bb2, max_ov2 = self._jit_pack(
                *blocks, self._luts, n_groups=n_groups, cap_words=cap_words,
                sampling=self._sampling, local_words=local_words,
                merge="segsum",
            )
        return dense, cap_words

    def _wait_groups(self, handles) -> bytes:
        out = bytearray()
        for (res, n_groups, cap_words, px_per_group) in handles:
            dense, bits, max_bb, max_ov, yb, cbb, crb = res
            bits_h = np.asarray(bits)
            used = (bits_h + 31) // 32
            total_used = int(used.sum())
            # Pooled capacity: the flat dense layout only needs the TOTAL
            # used words to fit (per-group spikes borrow from the band's
            # pool); when it doesn't, the device merge's clipped histogram
            # bins (including the overlap scalar) are garbage.
            pooled_over = total_used > n_groups * cap_words
            budget_over = int(max_bb) > self._local_words * 32
            overlap_over = (not pooled_over) and int(max_ov) > K_OVERLAP
            if pooled_over or budget_over or overlap_over:
                repack = self._repack_on_device(
                    (yb, cbb, crb), bits_h, int(max_bb), n_groups,
                    budget_over, overlap_over,
                )
                if repack is None:
                    out += self._host_fallback_groups((yb, cbb, crb), n_groups)
                    continue
                dense, cap_words = repack
            # Exact per-group bits feed the next submit's capacity budget.
            self._cap_recent.append(float(bits_h.max()) / max(1, px_per_group))
            offs = np.concatenate([[0], np.cumsum(used)[:-1]])
            fetch = min(
                dense.shape[0],
                -(-total_used // self._FETCH_BUCKET_WORDS) * self._FETCH_BUCKET_WORDS,
            )
            dense_h = np.asarray(dense[:fetch]) if fetch else np.empty(0, np.uint32)
            for g in range(n_groups):
                if self._groups_emitted:
                    out += self._rst_marker()
                self._groups_emitted += 1
                total = int(bits_h[g])
                n_bytes = (total + 7) // 8
                gw = dense_h[offs[g] : offs[g] + used[g]]
                data = bytearray(gw.astype(">u4").tobytes()[:n_bytes])
                rem = total % 8
                if rem and n_bytes:
                    data[-1] |= (1 << (8 - rem)) - 1  # pad with 1s (byte-align)
                payload = np.frombuffer(bytes(data), dtype=np.uint8)
                ff = np.nonzero(payload == 0xFF)[0]
                if len(ff):
                    payload = np.insert(payload, ff + 1, 0)
                out += payload.tobytes()
        return bytes(out)

    def _interleave_host(self, yc, yl, cbc, cbl, crc, crl):
        from ..codecs.jpeg.huffman import interleave_mcus

        if self._sampling != "420":
            return interleave_mcus([(yc, yl), (cbc, cbl), (crc, crl)])
        codes_parts, lens_parts = [], []
        for m in range(len(cbc)):
            for j in range(4):
                codes_parts.append(yc[m * 4 + j])
                lens_parts.append(yl[m * 4 + j])
            codes_parts.append(cbc[m])
            lens_parts.append(cbl[m])
            codes_parts.append(crc[m])
            lens_parts.append(crl[m])
        return np.concatenate(codes_parts), np.concatenate(lens_parts)

    def _host_fallback_groups(self, blocks, n_groups: int) -> bytes:
        """Exact host coding of a group-aligned band (overflow path)."""
        count("jpeg_host_fallback_bands")
        from ..codecs.jpeg.huffman import BitPacker, HuffmanEncoder

        yb, cbb, crb = (np.asarray(b) for b in blocks)
        dc_l, ac_l, dc_c, ac_c = self._host_tables
        enc_l = HuffmanEncoder(dc_l, ac_l)
        enc_c = HuffmanEncoder(dc_c, ac_c)
        ybpg = yb.shape[0] // n_groups
        cbpg = cbb.shape[0] // n_groups
        out = bytearray()
        for g in range(n_groups):
            if self._groups_emitted:
                out += self._rst_marker()
            self._groups_emitted += 1
            ysl = slice(g * ybpg, (g + 1) * ybpg)
            csl = slice(g * cbpg, (g + 1) * cbpg)
            packer = BitPacker()
            yc, yl, _ = enc_l.encode_component_blocks(yb[ysl], 0)
            cbc, cbl, _ = enc_c.encode_component_blocks(cbb[csl], 0)
            crc, crl, _ = enc_c.encode_component_blocks(crb[csl], 0)
            codes, lens = self._interleave_host(yc, yl, cbc, cbl, crc, crl)
            out += packer.pack(codes, lens)
            out += packer.flush()
        return bytes(out)

    def wait(self, handle) -> bytes:
        if isinstance(handle, tuple) and handle and handle[0] == "groups":
            return self._wait_groups(handle[1])
        words, total_bits, cap_words, max_bb, max_ov, blocks, prev_dc_in, _bb = handle
        total_bits = int(total_bits)
        if (
            int(max_bb) > self._local_words * 32
            or total_bits > cap_words * 32
            or int(max_ov) > K_OVERLAP
        ):
            # Pathological-entropy overflow: fetch the (device-computed,
            # hence bit-identical) quantized blocks and entropy-code this
            # band on the host. The device carry chain stays valid because
            # total_bits/new_dc were computed exactly regardless. Promote
            # the capacity budget so later bands stay on-device.
            if total_bits > cap_words * 32 and self._cap_bits_per_px < MAX_CAP_BITS_PER_PX:
                self._cap_bits_per_px = min(
                    MAX_CAP_BITS_PER_PX, self._cap_bits_per_px * 2
                )
            out = self._host_fallback_blocks(blocks, prev_dc_in)
            return out
        n_words = (total_bits + 31) // 32
        host_words = np.asarray(words[:n_words]).astype(">u4")
        data = bytearray(host_words.tobytes())
        # The band started at (previous total % 8); that's exactly the number
        # of carry bits the host holds in _carry_val.
        nbits_in = getattr(self, "_host_carry_n", 0)
        if nbits_in and data:
            data[0] |= (self._carry_val << (8 - nbits_in)) & 0xFF
        full_bytes = total_bits // 8
        rem = total_bits % 8
        if rem:
            carry_byte = data[full_bytes] if full_bytes < len(data) else 0
            self._carry_val = carry_byte >> (8 - rem)
        else:
            self._carry_val = 0
        self._host_carry_n = rem
        payload = np.frombuffer(bytes(data[:full_bytes]), dtype=np.uint8)
        ff = np.nonzero(payload == 0xFF)[0]
        if len(ff):
            payload = np.insert(payload, ff + 1, 0)
        return payload.tobytes()

    def _host_fallback_blocks(self, blocks, prev_dc_in) -> bytes:
        count("jpeg_host_fallback_bands")
        from ..codecs.jpeg.huffman import BitPacker, HuffmanEncoder

        yb, cbb, crb = (np.asarray(b) for b in blocks)
        dc_l, ac_l, dc_c, ac_c = self._host_tables
        enc_l = HuffmanEncoder(dc_l, ac_l)
        enc_c = HuffmanEncoder(dc_c, ac_c)
        packer = BitPacker()
        packer._carry_val = self._carry_val
        packer._carry_n = getattr(self, "_host_carry_n", 0)
        prev = [int(x) for x in np.asarray(prev_dc_in)]
        yc, yl, _ = enc_l.encode_component_blocks(yb, prev[0])
        cbc, cbl, _ = enc_c.encode_component_blocks(cbb, prev[1])
        crc, crl, _ = enc_c.encode_component_blocks(crb, prev[2])
        codes, lens = self._interleave_host(yc, yl, cbc, cbl, crc, crl)
        out = packer.pack(codes, lens)
        self._carry_val = packer._carry_val
        self._host_carry_n = packer._carry_n
        return out

    def flush(self) -> bytes:
        n = getattr(self, "_host_carry_n", 0)
        if n == 0:
            return b""
        pad = 8 - n
        byte = (self._carry_val << pad) | ((1 << pad) - 1)
        self._carry_val = 0
        self._host_carry_n = 0
        return b"\xff\x00" if byte == 0xFF else bytes([byte])


class DeviceEntropyPacker:
    """Streaming wrapper: device packs bits, host stuffs bytes + carries the
    sub-byte remainder and DC predictors between bands."""

    def __init__(self, dc_luma, ac_luma, dc_chroma, ac_chroma,
                 cap_bits_per_px: int = DEFAULT_CAP_BITS_PER_PX):
        self._luts = build_entropy_luts(dc_luma, ac_luma, dc_chroma, ac_chroma)
        self._host_tables = (dc_luma, ac_luma, dc_chroma, ac_chroma)
        self._prev_dc = jnp.zeros(3, dtype=jnp.int32)
        self._carry_val = 0
        self._carry_n = 0
        self._cap_bits_per_px = cap_bits_per_px
        self._jit = jax.jit(entropy_pack_trace, static_argnames=("cap_words",))
        self._fallback = None

    def pack_band(self, yb, cbb, crb, n_pixels: int) -> bytes:
        """Entropy-code one band of interleaved blocks (device arrays or
        numpy). Returns stuffed entropy bytes ready for the JPEG stream."""
        cap_words = max(64, (n_pixels * self._cap_bits_per_px + 31) // 32)
        words, total_bits, new_dc = self._jit(
            jnp.asarray(yb),
            jnp.asarray(cbb),
            jnp.asarray(crb),
            self._luts,
            self._prev_dc,
            jnp.int32(self._carry_n),
            cap_words=cap_words,
        )
        total_bits = int(total_bits)
        if total_bits > cap_words * 32:
            # Capacity overflow: host fallback for this band (keeps stream
            # valid; counts as a slow path, not an error).
            return self._host_fallback(yb, cbb, crb)
        self._prev_dc = new_dc
        n_words = (total_bits + 31) // 32
        host_words = np.asarray(words[:n_words]).astype(">u4")
        data = bytearray(host_words.tobytes())
        if self._carry_n:
            data[0] |= (self._carry_val << (8 - self._carry_n)) & 0xFF
        full_bytes = total_bits // 8
        rem = total_bits % 8
        if rem:
            carry_byte = data[full_bytes] if full_bytes < len(data) else 0
            self._carry_val = carry_byte >> (8 - rem)
        else:
            self._carry_val = 0
        self._carry_n = rem
        payload = np.frombuffer(bytes(data[:full_bytes]), dtype=np.uint8)
        ff = np.nonzero(payload == 0xFF)[0]
        if len(ff):
            payload = np.insert(payload, ff + 1, 0)
        return payload.tobytes()

    def _host_fallback(self, yb, cbb, crb) -> bytes:
        count("jpeg_host_fallback_bands")
        from ..codecs.jpeg.huffman import BitPacker, HuffmanEncoder, interleave_mcus

        dc_l, ac_l, dc_c, ac_c = self._host_tables
        if self._fallback is None:
            self._fallback = (
                HuffmanEncoder(dc_l, ac_l),
                HuffmanEncoder(dc_c, ac_c),
            )
        enc_l, enc_c = self._fallback
        packer = BitPacker()
        packer._carry_val = self._carry_val
        packer._carry_n = self._carry_n
        prev = [int(x) for x in np.asarray(self._prev_dc)]
        yc, yl, prev[0] = enc_l.encode_component_blocks(np.asarray(yb), prev[0])
        cbc, cbl, prev[1] = enc_c.encode_component_blocks(np.asarray(cbb), prev[1])
        crc, crl, prev[2] = enc_c.encode_component_blocks(np.asarray(crb), prev[2])
        codes, lens = interleave_mcus([(yc, yl), (cbc, cbl), (crc, crl)])
        out = packer.pack(codes, lens)
        self._carry_val = packer._carry_val
        self._carry_n = packer._carry_n
        self._prev_dc = jnp.asarray(prev, dtype=jnp.int32)
        return out

    def flush(self) -> bytes:
        """Pad the final partial byte with 1-bits."""
        if self._carry_n == 0:
            return b""
        pad = 8 - self._carry_n
        byte = (self._carry_val << pad) | ((1 << pad) - 1)
        self._carry_val = 0
        self._carry_n = 0
        return b"\xff\x00" if byte == 0xFF else bytes([byte])
