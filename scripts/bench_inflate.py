#!/usr/bin/env python
"""Microbenchmark: owned C++ inflate vs CPython zlib on bench-like data.

Times are CPU time (time.process_time), which neighbours on a shared host
disturb less than the wall clock.

Generates the same filtered-PNG payload class as bench.py's tiles (two
gradient channels, one 6-bit-noise channel, opaque alpha — a mostly-literal
stream after zlib-6), plus a high-redundancy payload (match-heavy), and
times both decoders in-process so host-load swings hit them equally.

Usage: python scripts/bench_inflate.py [mb] [reps]
"""

from __future__ import annotations

import os
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_payload(kind: str, size_mb: float) -> bytes:
    rng = np.random.default_rng(7)
    n_rows = int(size_mb * 1e6) // 4096
    if kind == "bench":
        size = 1024
        x = np.linspace(0, 255, size, dtype=np.float32)
        arr = np.empty((n_rows, size, 4), dtype=np.uint8)
        arr[:, :, 0] = (x[None, :] * 0.7)[None, :]
        arr[:, :, 1] = np.arange(n_rows, dtype=np.uint32)[:, None] % 256
        arr[:, :, 2] = rng.integers(0, 64, (n_rows, size), dtype=np.uint8) + 96
        arr[:, :, 3] = 255
        from image_stitch_tpu.ops.png_filter import filter_select_band

        raw = arr.reshape(n_rows, size * 4)
        types, filtered = filter_select_band(raw, None, 4)
        payload = np.empty((n_rows, 1 + size * 4), dtype=np.uint8)
        payload[:, 0] = types
        payload[:, 1:] = filtered
        return payload.tobytes()
    if kind == "text":
        base = (b"the quick brown fox jumps over the lazy dog %d\n" * 64)
        out = bytearray()
        i = 0
        while len(out) < size_mb * 1e6:
            out += base % tuple(range(i, i + 64))
            i += 1
        return bytes(out)
    raise SystemExit(f"unknown payload kind {kind}")


def time_owned(comp: bytes, out_len: int, reps: int) -> float:
    from image_stitch_tpu.native import NativeInflater

    best = float("inf")
    for _ in range(reps):
        inf = NativeInflater()
        out = np.empty(out_len, dtype=np.uint8)
        t0 = time.process_time()
        inf.feed(comp)
        total = 0
        while True:
            n = inf.drain_into(out)
            if n == 0:
                break
            total += n
        dt = time.process_time() - t0
        assert inf.finished and total == out_len, (total, out_len, inf.finished)
        best = min(best, dt)
    return best


def time_owned_banded(comp: bytes, out_len: int, reps: int, band: int) -> float:
    """Decode in band-sized output chunks, feeding input incrementally —
    the streaming decoder's actual call pattern."""
    from image_stitch_tpu.native import NativeInflater

    best = float("inf")
    chunks = [comp[i:i + 65536] for i in range(0, len(comp), 65536)]
    for _ in range(reps):
        inf = NativeInflater()
        out = np.empty(band, dtype=np.uint8)
        t0 = time.process_time()
        total = 0
        ci = 0
        while total < out_len:
            n = inf.drain_into(out)
            if n == 0:
                if ci < len(chunks):
                    inf.feed(chunks[ci])
                    ci += 1
                elif inf.finished:
                    break
                else:
                    raise AssertionError("stalled")
            total += n
        dt = time.process_time() - t0
        assert total == out_len
        best = min(best, dt)
    return best


def time_zlib(comp: bytes, out_len: int, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        d = zlib.decompressobj()
        t0 = time.process_time()
        out = d.decompress(comp)
        dt = time.process_time() - t0
        assert len(out) == out_len
        best = min(best, dt)
    return best


def main() -> None:
    size_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 48.0
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    for kind in ("bench", "text"):
        raw = make_payload(kind, size_mb)
        comp = zlib.compress(raw, 6)
        mb = len(raw) / 1e6
        t_owned = time_owned(comp, len(raw), reps)
        t_band = time_owned_banded(comp, len(raw), reps, 512 * 4100)
        t_z = time_zlib(comp, len(raw), reps)
        print(
            f"{kind}: {mb:.1f} MB raw, {len(comp)/1e6:.1f} MB comp "
            f"(ratio {len(raw)/len(comp):.2f})\n"
            f"  owned  {mb/t_owned:7.1f} MB/s\n"
            f"  banded {mb/t_band:7.1f} MB/s\n"
            f"  zlib   {mb/t_z:7.1f} MB/s   owned/zlib = {t_z/t_owned:.2f}x"
        )


if __name__ == "__main__":
    main()
