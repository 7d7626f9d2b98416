"""Device PNG filter selection (ops/device.filter_select_trace): exact
against the host oracle, unsharded and on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_stitch_tpu.ops.device import JaxBackend, _filter_select_jit, filter_select_trace
from image_stitch_tpu.ops.png_filter import filter_select_band


@pytest.mark.parametrize("shape", [(16, 512), (13, 260), (64, 1024)])
@pytest.mark.parametrize("bpp", [3, 4, 8])
def test_filter_select_trace_matches_oracle(shape, bpp):
    rng = np.random.default_rng(shape[0] * bpp)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    prev = rng.integers(0, 256, shape[1], dtype=np.uint8)
    types, filtered, last = _filter_select_jit(jnp.asarray(raw), jnp.asarray(prev), bpp=bpp)
    exp_types, exp_filtered = filter_select_band(raw, prev, bpp)
    np.testing.assert_array_equal(np.asarray(types), exp_types)
    np.testing.assert_array_equal(np.asarray(filtered), exp_filtered)
    np.testing.assert_array_equal(np.asarray(last), raw[-1])


def test_filter_select_trace_no_prev():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (24, 400), dtype=np.uint8)
    types, filtered, _ = _filter_select_jit(
        jnp.asarray(raw), jnp.zeros((400,), jnp.uint8), bpp=4
    )
    exp_types, exp_filtered = filter_select_band(raw, None, 4)
    np.testing.assert_array_equal(np.asarray(types), exp_types)
    np.testing.assert_array_equal(np.asarray(filtered), exp_filtered)


@pytest.mark.parametrize("shape", [(64, 128), (37, 65)])
def test_filter_select_sharded_matches_oracle(shape):
    """The mesh path (rows over 'band', row bytes over 'x' when they
    divide): bit-identical to the host oracle on the 8-device CPU mesh."""
    from image_stitch_tpu.parallel.mesh import make_mesh

    h, w = shape
    rng = np.random.default_rng(h)
    canvas = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    prev = rng.integers(0, 256, w * 4, dtype=np.uint8)
    types, filtered, last = JaxBackend(mesh=make_mesh(8)).png_filter_band(canvas, prev)
    raw = canvas.reshape(h, w * 4)
    exp_types, exp_filtered = filter_select_band(raw, prev, 4)
    np.testing.assert_array_equal(np.asarray(types), exp_types)
    np.testing.assert_array_equal(np.asarray(filtered), exp_filtered)
    np.testing.assert_array_equal(np.asarray(last), raw[-1])


def test_filter_select_writes_no_candidate_stack():
    """The five filter candidates are reduced and selected without a
    (5, H, N) tensor in the compiled program."""
    raw = jnp.zeros((16, 512), jnp.uint8)
    hlo = (
        jax.jit(filter_select_trace, static_argnames=("bpp",))
        .lower(raw, raw[0], 4)
        .compile()
        .as_text()
    )
    assert "[5,16,512]" not in hlo
