"""host_threads worker-pool decode tier: output bytes must be identical to
the serial path at any thread count (assembly order is deterministic), errors
must propagate with input context, and progress totals must hold under
concurrent consumption. An extension — the single-threaded Node
reference has no analog (SURVEY §2)."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from utils.fixtures import gradient_png, png_from_array, random_rgba, solid_png

from image_stitch_tpu import PositionedImage, concat_to_buffer
from image_stitch_tpu.errors import StitchError


def _tiles(n: int, size: int = 96):
    tiles = []
    for i in range(n):
        arr = random_rgba(size, size, seed=i)
        tiles.append(png_from_array(arr))
    return tiles


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_grid_threads_bit_identical(fmt):
    tiles = _tiles(9)
    opts = {"inputs": tiles, "layout": {"columns": 3}, "outputFormat": fmt}
    serial = concat_to_buffer({**opts, "hostThreads": 1})
    threaded = concat_to_buffer({**opts, "hostThreads": 4})
    assert serial == threaded


def test_grid_threads_mixed_sizes_bit_identical():
    inputs = [
        gradient_png(120, 40),
        solid_png(60, 90, (0, 128, 255, 200)),
        png_from_array(random_rgba(80, 80, seed=3)),
        gradient_png(33, 77),
    ]
    opts = {"inputs": inputs, "layout": {"columns": 2}}
    assert concat_to_buffer({**opts, "hostThreads": 1}) == concat_to_buffer(
        {**opts, "hostThreads": 8}
    )


def test_positioned_threads_bit_identical():
    bg = solid_png(200, 150, (10, 20, 30, 255))
    sprites = [
        PositionedImage(
            x=17 * i,
            y=11 * i,
            z_index=i % 3,
            source=png_from_array(random_rgba(50, 50, seed=10 + i) // 2 + 64),
        )
        for i in range(6)
    ]
    inputs = [PositionedImage(x=0, y=0, source=bg)] + sprites
    opts = {"inputs": inputs}
    assert concat_to_buffer({**opts, "hostThreads": 1}) == concat_to_buffer(
        {**opts, "hostThreads": 4}
    )


def test_threads_error_propagates_with_input_context():
    tiles = _tiles(4)
    # Truncate input #3 mid-IDAT: its decoder ends early and the row server
    # must raise a dimension mismatch naming the input.
    tiles[2] = tiles[2][: len(tiles[2]) // 2]
    with pytest.raises(StitchError) as exc_info:
        concat_to_buffer(
            {"inputs": tiles, "layout": {"columns": 2}, "hostThreads": 4}
        )
    assert "#3" in str(exc_info.value)


def test_threads_progress_counts_every_input_once():
    tiles = _tiles(6, size=64)
    events = []
    out = concat_to_buffer(
        {
            "inputs": tiles,
            "layout": {"columns": 3},
            "hostThreads": 4,
            "onProgress": lambda done, total: events.append((done, total)),
        }
    )
    assert out[:8] == b"\x89PNG\r\n\x1a\n"
    assert events[-1] == (6, 6)
    completed = [done for done, _ in events]
    assert completed == sorted(completed)  # monotone
    assert len(events) == 6  # one completion event per input


def test_threads_with_shared_input_cache():
    from image_stitch_tpu import disable_input_cache, enable_input_cache

    tile = png_from_array(random_rgba(64, 64, seed=42))
    try:
        enable_input_cache()
        opts = {"inputs": [tile] * 9, "layout": {"columns": 3}}
        threaded = concat_to_buffer({**opts, "hostThreads": 4})
    finally:
        disable_input_cache()
    serial = concat_to_buffer({**opts, "hostThreads": 1})
    assert serial == threaded


def test_env_var_enables_threads(monkeypatch):
    monkeypatch.setenv("STITCH_TPU_HOST_THREADS", "3")
    tiles = _tiles(4, size=48)
    opts = {"inputs": tiles, "layout": {"columns": 2}}
    via_env = concat_to_buffer(opts)  # host_threads=0 -> env
    monkeypatch.delenv("STITCH_TPU_HOST_THREADS")
    assert via_env == concat_to_buffer(opts)


def test_negative_host_threads_rejected():
    with pytest.raises(StitchError):
        concat_to_buffer(
            {"inputs": [solid_png(8, 8)], "layout": {"columns": 1}, "hostThreads": -1}
        )


def test_threads_lookahead_many_bands_bit_identical():
    """Small band_height forces many bands through the one-band lookahead
    prefetch; bytes must still match serial, and a truncated input must
    surface its error even when discovered in a prefetched band."""
    tiles = _tiles(4, size=80)
    opts = {"inputs": tiles, "layout": {"columns": 2}, "bandHeight": 16}
    assert concat_to_buffer({**opts, "hostThreads": 1}) == concat_to_buffer(
        {**opts, "hostThreads": 4}
    )
    tiles[1] = tiles[1][: len(tiles[1]) * 2 // 3]
    with pytest.raises(StitchError) as exc_info:
        concat_to_buffer(
            {"inputs": tiles, "layout": {"columns": 2}, "bandHeight": 16,
             "hostThreads": 4}
        )
    assert "#2" in str(exc_info.value)


def test_parallel_deflate_bit_identical_and_valid():
    """PNG output under host_threads runs the parallel deflate tier (each
    sync-flush batch compresses on a worker with the previous batch's raw
    tail as dictionary). The zlib stream must be byte-identical to serial
    across multiple flush boundaries."""
    import zlib

    from image_stitch_tpu.native import native_available

    if not native_available():
        pytest.skip("parallel deflate rides the native tier")

    rng = np.random.default_rng(9)
    # ~6 MB of canvas -> several 1 MB sync-flush batches
    tiles = [
        png_from_array(
            (rng.integers(0, 64, (256, 256, 4)) + 96).astype(np.uint8)
        )
        for _ in range(24)
    ]
    opts = {"inputs": tiles, "layout": {"columns": 6}}
    serial = concat_to_buffer({**opts, "hostThreads": 1})
    # Spy on the batch compressor: the parallel tier must actually engage
    # (guards against plumbing regressions that silently fall back to
    # serial, which would make this test pass vacuously).
    import threading

    from image_stitch_tpu.native import NativeDeflator

    batch_threads: set[str] = set()
    orig = NativeDeflator._compress_batch

    def spy(*args):
        batch_threads.add(threading.current_thread().name)
        return orig(*args)

    NativeDeflator._compress_batch = staticmethod(spy)
    try:
        threaded = concat_to_buffer({**opts, "hostThreads": 4})
    finally:
        NativeDeflator._compress_batch = staticmethod(orig)
    assert serial == threaded
    assert any(t != "MainThread" for t in batch_threads), batch_threads
    # Independent validity check: PIL decodes the threaded output exactly.
    from PIL import Image
    import io as _io

    arr = np.asarray(Image.open(_io.BytesIO(threaded)))
    ref = np.asarray(Image.open(_io.BytesIO(tiles[0])))
    assert (arr[:256, :256] == ref).all()


def test_parallel_deflate_streaming_order_preserved():
    """Chunks may be emitted with a lag under the pool, but always in
    order: reassembling the streamed chunks equals the buffered output."""
    from image_stitch_tpu import concat_streaming

    tiles = _tiles(9, size=200)
    opts = {"inputs": tiles, "layout": {"columns": 3}, "hostThreads": 4}
    streamed = b"".join(concat_streaming(opts))
    assert streamed == concat_to_buffer({**opts})


def test_concurrent_concat_calls_from_user_threads():
    """Library thread-safety: independent concat calls running concurrently
    on USER threads (each possibly with its own internal pool) must not
    interfere — shared state is the buffer pool, native lib, and registry."""
    from concurrent.futures import ThreadPoolExecutor

    def job(seed):
        tiles = [
            png_from_array(random_rgba(60, 44, seed=seed * 10 + k))
            for k in range(4)
        ]
        opts = {"inputs": tiles, "layout": {"columns": 2},
                "hostThreads": 2 if seed % 2 else 1}
        return concat_to_buffer(opts)

    serial = [job(s) for s in range(6)]
    with ThreadPoolExecutor(max_workers=6) as pool:
        concurrent = list(pool.map(job, range(6)))
    assert serial == concurrent
