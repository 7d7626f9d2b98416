"""Multi-chip orchestrator integration: `concat_to_buffer` over a device
mesh must produce byte-identical output to the single-device and host paths
(SURVEY §5 "Distributed communication backend" — the
sharding is annotation-only, so collectives change nothing observable).

Runs on the 8-virtual-CPU-device mesh from conftest.
"""

import io

import numpy as np
import pytest

from image_stitch_tpu import concat_to_buffer

from tests.utils.fixtures import decode_png_pil, png_from_array


def noisy_tile(seed: int, w: int = 96, h: int = 80) -> np.ndarray:
    r = np.random.default_rng(seed)
    x = np.linspace(0, 255, w).astype(np.uint8)
    a = np.zeros((h, w, 4), np.uint8)
    a[:, :, 0] = x[None, :]
    a[:, :, 1] = seed * 37 % 256
    a[:, :, 2] = x[None, ::-1]
    a[:, :, 3] = 255
    return (
        (a.astype(np.int16) + r.integers(-10, 11, a.shape)).clip(0, 255).astype(np.uint8)
    )


@pytest.fixture(scope="module")
def tiles():
    return [png_from_array(noisy_tile(i)) for i in range(4)]


def _run(tiles, mesh=None, backend=None, **extra):
    opts = {
        "inputs": tiles,
        "layout": {"columns": 2},
        "bandHeight": 48,
        **extra,
    }
    if mesh is not None:
        opts["mesh"] = mesh
    if backend is not None:
        opts["backend"] = backend
    return concat_to_buffer(opts)


def test_sharded_png_bytes_match_host(tiles):
    shard = _run(tiles, mesh=8)
    host = _run(tiles, backend="numpy")
    assert shard == host


def test_sharded_png_bytes_match_single_device(tiles):
    shard = _run(tiles, mesh=8)
    single = _run(tiles, backend="jax")
    assert shard == single


def test_sharded_jpeg_bytes_match_host(tiles):
    shard = _run(tiles, mesh=8, outputFormat="jpeg")
    host = _run(tiles, backend="numpy", outputFormat="jpeg")
    assert shard == host


@pytest.mark.parametrize("ri", [1, 2])
def test_sharded_jpeg_restart_groups_match_host(tiles, ri):
    """Restart groups are the parallel-entropy unit: byte-aligned, DC-reset,
    packed per-device — byte-identical to the sequential host coder. Both
    the entropy layer and the quantize stage (ops/jpeg_dct integer
    pipeline) are exact by construction, so this holds for ANY content."""
    kw = {"outputFormat": "jpeg", "jpeg_restart_interval_rows": ri}
    shard = _run(tiles, mesh=8, **kw)
    host = _run(tiles, backend="numpy", **kw)
    single = _run(tiles, backend="jax", **kw)
    assert shard == host
    assert shard == single


def test_mesh_restart_groups_trace_once_across_runs(tiles, monkeypatch):
    """Encoders on equal meshes share one traced program: a second run over
    the same mesh re-traces nothing (each re-trace costs seconds on a
    four-card mesh)."""
    import image_stitch_tpu.ops.jpeg_entropy_device as E

    traces = []
    orig = E._pack_dispatch
    monkeypatch.setattr(
        E, "_pack_dispatch", lambda *a, **k: traces.append(1) or orig(*a, **k)
    )
    kw = {"outputFormat": "jpeg", "jpeg_restart_interval_rows": 1,
          "jpegQuality": 61}
    first = _run(tiles, mesh=4, **kw)
    after_first = len(traces)
    assert _run(tiles, mesh=4, **kw) == first
    assert len(traces) == after_first


def test_sharded_output_decodes_correctly(tiles):
    """Independent-oracle check: PIL decode of the sharded PNG equals the
    assembled input mosaic."""
    out = _run(tiles, mesh=8)
    arr = decode_png_pil(out)
    top = np.concatenate([noisy_tile(0), noisy_tile(1)], axis=1)
    bot = np.concatenate([noisy_tile(2), noisy_tile(3)], axis=1)
    np.testing.assert_array_equal(arr, np.concatenate([top, bot], axis=0))


def test_mesh_accepts_mesh_object(tiles):
    from image_stitch_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    out = _run(tiles, mesh=mesh)
    host = _run(tiles, backend="numpy")
    assert out == host


def test_mesh_uneven_band_height(tiles):
    """Band heights that don't divide the mesh band axis: rows are
    edge-padded (exact — the per-row argmin and input-data carry are
    unaffected) and outputs sliced."""
    shard = _run(tiles, mesh=8, bandHeight=37)
    host = _run(tiles, backend="numpy", bandHeight=37)
    assert shard == host


def test_mesh_x_indivisible_row_bytes(tiles):
    """Row bytes not divisible by the 'x' axis fall back to rows-only
    sharding, still byte-exact (mesh=3 -> x=3, 384 % 3 = 0 but 97px tile
    gives 388 % 3 != 0)."""
    from tests.utils.fixtures import png_from_array

    t = png_from_array(noisy_tile(9, w=97, h=41))
    shard = concat_to_buffer(
        {"inputs": [t], "layout": {"columns": 1}, "mesh": 3, "bandHeight": 29}
    )
    host = concat_to_buffer(
        {"inputs": [t], "layout": {"columns": 1}, "backend": "numpy", "bandHeight": 29}
    )
    assert shard == host


def test_mesh_oversubscription_rejected(tiles):
    from image_stitch_tpu import StitchError

    with pytest.raises(StitchError, match="devices"):
        _run(tiles, mesh=64)


def test_mesh_sharded_matches_single_device_at_q100(tiles):
    """Mesh-vs-single byte equality at q100, where every quantization
    rounding boundary is exposed (q=1 steps). Exact for any content since
    the integer quantize pipeline (ops/jpeg_dct) has no f32 ties."""
    kw = {"outputFormat": "jpeg", "jpegQuality": 100, "jpeg_restart_interval_rows": 1}
    shard = _run(tiles, mesh=8, **kw)
    single = _run(tiles, backend="jax", **kw)
    assert shard == single


def test_sharded_png_exact_on_full_range_noise():
    """PNG's pipeline is all-integer: byte equality holds for ANY content
    and ANY mesh factoring."""
    rng = np.random.default_rng(123)
    arrs = [rng.integers(0, 256, (128, 128, 4), dtype=np.uint8) for _ in range(4)]
    host = concat_to_buffer({"inputs": arrs, "layout": {"columns": 2}, "backend": "numpy"})
    for mesh in (8, 3):
        shard = concat_to_buffer({"inputs": arrs, "layout": {"columns": 2}, "mesh": mesh})
        assert shard == host


def test_mesh_with_host_threads_bytes_match(tiles):
    """Mesh sharding (device band programs) composes with the host_threads
    decode/deflate pool: bytes must match the serial host run exactly."""
    host = _run(tiles, backend="numpy")
    sharded_threaded = _run(tiles, mesh=8, hostThreads=4)
    assert host == sharded_threaded


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_mesh_sizes_png_bytes_match_host(tiles, n_dev):
    """PNG bytes are mesh-size invariant (all-integer pipeline): every
    mesh factoring must reproduce the host bytes exactly."""
    host = _run(tiles, backend="numpy")
    assert _run(tiles, mesh=n_dev) == host


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_sizes_jpeg_restart_groups_match_host(tiles, n_dev):
    """Restart-group entropy coding is the parallel unit: byte-exact vs
    host for every mesh size (exact integer pipeline end to end)."""
    host = _run(tiles, backend="numpy", outputFormat="jpeg",
                jpegRestartIntervalRows=1)
    sharded = _run(tiles, mesh=n_dev, outputFormat="jpeg",
                   jpegRestartIntervalRows=1)
    assert sharded == host


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_jpeg_exact_on_full_range_noise(n_dev):
    """JPEG bytes are now mesh-invariant UNCONDITIONALLY: the
    quantize stage is exact integer math (ops/jpeg_dct), so there
    is no f32 round-half tie left for GSPMD resharding to flip. Full-range
    noise maximizes coefficient/rounding-boundary coverage; saturated
    checkerboards (the content that exposed tie flips in the f32 era) are
    mixed in."""
    rng = np.random.default_rng(321)
    arrs = [rng.integers(0, 256, (96, 96, 4), dtype=np.uint8) for _ in range(3)]
    sat = np.zeros((96, 96, 4), np.uint8)
    sat[..., 0] = 255
    sat[..., 2] = (rng.integers(0, 2, (96, 96)) * 255).astype(np.uint8)
    sat[..., 3] = 255
    arrs.append(sat)
    kw = {"layout": {"columns": 2}, "outputFormat": "jpeg",
          "jpeg_restart_interval_rows": 1}
    host = concat_to_buffer({"inputs": arrs, "backend": "numpy", **kw})
    shard = concat_to_buffer({"inputs": arrs, "mesh": n_dev, **kw})
    assert shard == host


def test_northstar_shape_sharded_streaming_bytes_and_memory():
    """Scaled-down BASELINE.md config 5 (the flagship): a 16-column grid of
    tiles streamed to JPEG with restart groups over the 8-device mesh —
    byte identity vs the host path AND the streaming memory property
    asserted together.

    The memory assertion samples LIVE JAX ARRAY BYTES per yielded band
    rather than RSS: glibc/XLA transient scratch makes process-RSS deltas
    swing 40-200 MB at this toy scale regardless of canvas size (measured
    round 4), while live-array bytes directly expose the regression this
    guards against — per-band device buffers accumulating with canvas
    height instead of being released band-by-band. The RSS-class
    O(canvas_width) claim is proven at real scale by the default-on
    20000^2 host memory test (test_memory_streaming.py)."""
    import jax

    from image_stitch_tpu import concat_streaming

    grid, tile, rows = 16, 64, 80  # 1024 px wide, 5120 tall: 40 bands
    t = [png_from_array(noisy_tile(i, w=tile, h=tile)) for i in range(4)]
    inputs = [t[i % 4] for i in range(grid * rows)]
    common = {
        "inputs": inputs,
        "layout": {"columns": grid},
        "outputFormat": "jpeg",
        "jpegQuality": 85,
        "jpeg_restart_interval_rows": 1,
        "bandHeight": 128,
    }
    host = b"".join(concat_streaming({**common, "backend": "numpy"}))

    # Warm pass compiles the mesh programs outside the measured region.
    b"".join(concat_streaming({**common, "mesh": 8}))

    base_live = sum(x.nbytes for x in jax.live_arrays())
    peak_live = 0
    parts = []
    for chunk in concat_streaming({**common, "mesh": 8}):
        parts.append(chunk)
        live = sum(x.nbytes for x in jax.live_arrays()) - base_live
        peak_live = max(peak_live, live)

    assert b"".join(parts) == host
    band_bytes = grid * tile * 128 * 4  # one RGBA band: 512 KB
    n_bands = (rows * tile + 127) // 128
    # Streaming: live device bytes stay a small band multiple (measured
    # ~3.4 bands peak), never the O(n_bands) of an accumulating run.
    budget = 10 * band_bytes
    assert peak_live < budget, (
        f"peak live jax bytes {peak_live} >= {budget} "
        f"({peak_live / band_bytes:.1f} bands live; accumulation over "
        f"{n_bands} bands would be ~{n_bands * band_bytes})"
    )
