"""Fused uniform-grid compose + encode — the flagship device program.

For the common production case (a uniform grid of same-sized tiles, e.g. the
16x16 grid of 4K tiles in BASELINE.md) the whole per-band pipeline fuses into
one XLA program with zero host round-trips between stages:

    stacked tiles -> canvas layout -> PNG filter-select
                                   -> JPEG YCbCr + DCT + quantize

The reference walks this per scanline per tile in JS
(image-concat-core.ts:389-549); here the canvas assembly is a pure
transpose/reshape (free for XLA), and both encoders consume the canvas from
device memory without a round trip through host memory.

These functions are pure traces — jit/shard them from
:mod:`image_stitch_tpu.parallel.mesh`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .device import filter_select_trace, jpeg_quantize_trace


def assemble_uniform_grid(tiles: jax.Array) -> jax.Array:
    """(gy, gx, th, tw, 4) tiles -> (gy*th, gx*tw, 4) canvas.

    A transpose+reshape — XLA lowers it to a layout change, and under a mesh
    sharded on gx the canvas columns stay device-local.
    """
    gy, gx, th, tw, c = tiles.shape
    return tiles.transpose(0, 2, 1, 3, 4).reshape(gy * th, gx * tw, c)


def fused_grid_png_step(tiles: jax.Array, prev_row: jax.Array):
    """Uniform grid band -> PNG filter-selected rows.

    tiles: (gy, gx, th, tw, 4) uint8. prev_row: (gx*tw*4,) uint8 carry.
    Returns (filter_types (gy*th,), filtered (gy*th, W*4), last_raw (W*4,)).
    """
    canvas = assemble_uniform_grid(tiles)
    h, w, _ = canvas.shape
    raw = canvas.reshape(h, w * 4)
    return filter_select_trace(raw, prev_row, 4)


def fused_grid_jpeg_step(
    tiles: jax.Array, luma_q: jax.Array, chroma_q: jax.Array
):
    """Uniform grid band -> quantized JPEG blocks (Y, Cb, Cr)."""
    canvas = assemble_uniform_grid(tiles)
    return jpeg_quantize_trace(canvas, luma_q, chroma_q)


def fused_grid_dual_step(
    tiles: jax.Array,
    prev_row: jax.Array,
    luma_q: jax.Array,
    chroma_q: jax.Array,
):
    """Both encoders from one canvas materialization — the full forward step
    used by __graft_entry__ and the multichip dryrun."""
    canvas = assemble_uniform_grid(tiles)
    h, w, _ = canvas.shape
    ftypes, filtered, last = filter_select_trace(
        canvas.reshape(h, w * 4), prev_row, 4
    )
    yb, cbb, crb = jpeg_quantize_trace(canvas, luma_q, chroma_q)
    return ftypes, filtered, last, yb, cbb, crb
