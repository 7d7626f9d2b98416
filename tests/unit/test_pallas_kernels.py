"""The phase-1 pack kernel (ops/pallas_kernels.py): in Pallas interpret
mode on the CPU it must match the plain XLA form bit for bit; compiled for
the GPU, the `gpu` test does the same at a real band width. _pack_dispatch
picks the kernel on a GPU and the XLA form elsewhere, and shards the
blocks over a mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import Mesh

from image_stitch_tpu.ops import pallas_kernels as PK
from image_stitch_tpu.ops.jpeg_entropy_device import _pack_blocks_aligned, _pack_dispatch
from image_stitch_tpu.ops.pallas_kernels import PACK_LANES, pack_blocks_aligned_pallas


def _streams(nb, n_sym, lw, seed):
    """Random symbol streams with zero-length symbols, blocks within the
    local_words budget, and a non-zero start alignment."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 17, size=(nb, n_sym)).astype(np.int32)
    lens[rng.random(lens.shape) < 0.3] = 0
    mask = ((1 << lens.astype(np.int64)) - 1).astype(np.uint32)
    codes = rng.integers(0, 1 << 16, size=(nb, n_sym)).astype(np.uint32) & mask
    over = lens.sum(axis=1) > lw * 32
    lens[over] = np.minimum(lens[over], 4)
    starts = (
        np.cumsum(np.concatenate([[0], lens.sum(axis=1)[:-1]])).astype(np.int32)
        + int(rng.integers(0, 32))
    )
    return jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(starts)


def _check(nb, n_sym, lw, seed, interpret=True):
    codes, lens, starts = _streams(nb, n_sym, lw, seed)
    ref = np.asarray(_pack_blocks_aligned(codes, lens, starts, lw, transpose=False))
    got = np.asarray(
        pack_blocks_aligned_pallas(codes, lens, starts, lw, interpret=interpret)
    )
    assert got.shape == ref.shape == (lw + 2, nb)
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize(
    "nb,n_sym,lw,seed",
    [(596, 43, 12, 0), (262, 41, 9, 1), (694, 3, 8, 2), (10, 11, 13, 3),
     (512, 65, 16, 4)],
)
def test_pack_blocks_aligned_pallas_matches_xla(nb, n_sym, lw, seed):
    """Bit-identical to the XLA fori_loop form on random symbol streams."""
    _check(nb, n_sym, lw, seed)


@pytest.mark.parametrize("n_sym", [1, 64, 65, 66])
def test_pack_kernel_symbol_counts(n_sym):
    """Odd counts leave the last pair's second symbol masked out."""
    _check(300, n_sym, 12, n_sym)


@pytest.mark.parametrize("nb", [1, PACK_LANES - 1, PACK_LANES + 1, 3 * PACK_LANES])
def test_pack_kernel_block_counts(nb):
    """Block counts off the PACK_LANES tile: the tail program masks."""
    _check(nb, 65, 12, nb)


@pytest.mark.parametrize("lw", [12, 16, 24])
def test_pack_kernel_encoder_budgets(lw):
    """The local_words budgets the encoder uses (q<=85, q<=95, q100)."""
    _check(700, 65, lw, lw)


def test_pack_kernel_interprets_off_the_gpu():
    """interpret=True runs the kernel in the Pallas interpreter on the CPU."""
    codes, lens, starts = _streams(40, 65, 12, 9)
    ref = np.asarray(_pack_blocks_aligned(codes, lens, starts, 12, transpose=False))
    got = np.asarray(pack_blocks_aligned_pallas(codes, lens, starts, 12, interpret=True))
    np.testing.assert_array_equal(ref, got)


def _kernel_on_gpu(monkeypatch, calls):
    """Pretend the default backend is a GPU; the kernel runs interpreted."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")

    def interpreted(codes, lens, starts, local_words):
        calls.append(codes.shape[0])
        return pack_blocks_aligned_pallas(codes, lens, starts, local_words,
                                          interpret=True)

    monkeypatch.setattr(PK, "pack_blocks_aligned_pallas", interpreted)


@pytest.mark.parametrize("transpose", [True, False])
def test_pack_dispatch_off_the_gpu_is_the_xla_form(monkeypatch, transpose):
    def no_kernel(*a, **k):
        raise AssertionError("the Triton kernel was called off the GPU")

    monkeypatch.setattr(PK, "pack_blocks_aligned_pallas", no_kernel)
    codes, lens, starts = _streams(300, 65, 12, 5)
    ref = _pack_blocks_aligned(codes, lens, starts, 12, transpose=transpose)
    got = _pack_dispatch(codes, lens, starts, 12, transpose=transpose)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_pack_dispatch_on_the_gpu_calls_the_kernel(monkeypatch):
    calls = []
    _kernel_on_gpu(monkeypatch, calls)
    codes, lens, starts = _streams(300, 65, 12, 6)
    ref = _pack_blocks_aligned(codes, lens, starts, 12)
    got = _pack_dispatch(codes, lens, starts, 12)
    assert calls == [300]
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def _mesh4():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("band", "x"))


@pytest.mark.parametrize("form", ["xla", "kernel"])
@pytest.mark.parametrize("nb,per_device", [(1024, 256), (1022, 1022)])
def test_pack_dispatch_shards_blocks_over_a_mesh(monkeypatch, form, nb, per_device):
    """With a mesh each device packs nb / mesh.size blocks (whole-array
    fallback when nb does not divide); the words are unchanged."""
    calls = []
    if form == "kernel":
        _kernel_on_gpu(monkeypatch, calls)
    codes, lens, starts = _streams(nb, 65, 12, nb)
    ref = _pack_blocks_aligned(codes, lens, starts, 12, transpose=False)
    got = _pack_dispatch(codes, lens, starts, 12, transpose=False, mesh=_mesh4())
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))
    if form == "kernel":
        assert calls and set(calls) == {per_device}


@pytest.mark.gpu
def test_pack_kernel_compiled_on_gpu_matches_xla():
    """Compiled through Triton at the block count of a 512 x 8192 4:4:4
    band (196,608 blocks)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check there")
    _check(512 * 8192 // 64 * 3, 65, 12, 0, interpret=False)
