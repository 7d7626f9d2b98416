"""Pallas kernel (Triton route) for phase-1 JPEG symbol packing.

:func:`pack_blocks_aligned_pallas` computes exactly what
``ops/jpeg_entropy_device._pack_blocks_aligned(..., transpose=False)``
computes. The XLA form is a ~33-step ``fori_loop`` whose every step reads
and writes the whole (AW, nb) word buffer in device memory; here one
program owns a block of PACK_LANES JPEG blocks and keeps that block's
(AW, lanes) accumulator in registers for the whole symbol chain, so device
memory sees the symbol stream once and the packed words once.

The kernel compiles through Triton, so it runs on NVIDIA GPUs only;
``interpret=True`` runs it in the Pallas interpreter on any backend (the
CPU test suite). ``_pack_dispatch`` picks this kernel or the XLA form.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

PACK_LANES = 256  # JPEG blocks per program (a power of two, as Triton needs)


def _pack_kernel(codes_ref, lens_ref, off_ref, out_ref, *, nb: int,
                 n_sym: int, n_aw: int, aw_pad: int):
    """One program: blocks [pid*PACK_LANES, (pid+1)*PACK_LANES).

    ``codes_ref``/``lens_ref`` hold the (n_sym, nb) symbol streams
    flattened symbol-major; ``out_ref`` the (n_aw, nb) words flattened
    word-major. Same per-pair math as _pack_blocks_aligned's step()."""
    b = pl.program_id(0) * PACK_LANES + jnp.arange(PACK_LANES, dtype=jnp.int32)
    valid = b < nb
    word = jnp.arange(aw_pad, dtype=jnp.int32)[:, None]  # (AW_pad, 1)
    off0 = plgpu.load(off_ref.at[b], mask=valid, other=0)

    def step(s, carry):
        local, off = carry
        has2 = valid & (2 * s + 1 < n_sym)
        c1 = plgpu.load(codes_ref.at[2 * s * nb + b], mask=valid, other=0)
        l1 = plgpu.load(lens_ref.at[2 * s * nb + b], mask=valid, other=0)
        c2 = plgpu.load(codes_ref.at[(2 * s + 1) * nb + b], mask=has2, other=0)
        l2 = plgpu.load(lens_ref.at[(2 * s + 1) * nb + b], mask=has2, other=0)
        l2u = l2.astype(jnp.uint32)
        v_lo = (c1 << l2u) | c2
        v_hi = jnp.where(
            l2 == 0,
            jnp.uint32(0),
            c1 >> jnp.clip(32 - l2, 0, 31).astype(jnp.uint32),
        )
        end = off + l1 + l2
        sh = ((32 - (end & 31)) & 31).astype(jnp.uint32)
        inv = jnp.clip(32 - sh.astype(jnp.int32), 0, 31).astype(jnp.uint32)
        lo_spill = jnp.where(sh == 0, jnp.uint32(0), v_lo >> inv)
        hi_spill = jnp.where(sh == 0, jnp.uint32(0), v_hi >> inv)
        d_lo = v_lo << sh
        d_mid = (v_hi << sh) | lo_spill
        w_e = (end - 1) >> 5
        w0c = jnp.clip(w_e, 0, n_aw - 1)
        w1c = jnp.clip(w_e - 1, 0, n_aw - 1)
        w2c = jnp.clip(w_e - 2, 0, n_aw - 1)
        local = local | (
            jnp.where(word == w0c[None, :], d_lo[None, :], jnp.uint32(0))
            | jnp.where(word == w1c[None, :], d_mid[None, :], jnp.uint32(0))
            | jnp.where(word == w2c[None, :], hi_spill[None, :], jnp.uint32(0))
        )
        return local, end

    local = jnp.zeros((aw_pad, PACK_LANES), jnp.uint32)
    local, _ = jax.lax.fori_loop(0, (n_sym + 1) // 2, step, (local, off0))
    plgpu.store(
        out_ref.at[word * nb + b[None, :]], local,
        mask=(word < n_aw) & valid[None, :],
    )


@functools.partial(jax.jit, static_argnames=("local_words", "interpret"))
def pack_blocks_aligned_pallas(codes, lens, starts, local_words: int,
                               interpret: bool = False):
    """(nb, n_sym) symbol streams -> (local_words + 2, nb) uint32 words
    pre-aligned to each block's global start bit; bit-identical to
    ``_pack_blocks_aligned(codes, lens, starts, local_words,
    transpose=False)``."""
    nb, n_sym = codes.shape
    n_aw = local_words + 2
    aw_pad = pl.next_power_of_2(n_aw)
    out = pl.pallas_call(
        functools.partial(
            _pack_kernel, nb=nb, n_sym=n_sym, n_aw=n_aw, aw_pad=aw_pad
        ),
        out_shape=jax.ShapeDtypeStruct((n_aw * nb,), jnp.uint32),
        grid=(pl.cdiv(nb, PACK_LANES),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="jpeg_pack_blocks",
    )(
        codes.T.astype(jnp.uint32).reshape(-1),
        lens.T.astype(jnp.int32).reshape(-1),
        (starts & 31).astype(jnp.int32),
    )
    return out.reshape(n_aw, nb)
