#!/usr/bin/env python
"""Interleaved sweep of the level-6 deflate profile knobs.

Builds one .so per variant (same source, -DDEFL_L6_* overrides), loads
them all in ONE process, and alternates timed runs per round, so clock
swings on a shared host hit every variant alike. Reports
CPU-time MB/s and output size per variant plus zlib-6's size (the ratio
contract: stay at-or-under zlib-6 on bench content).

Usage: python scripts/sweep_deflate_profile.py [mb] [rounds]
Env: SWEEP_DEFL="name=chain,maxlazy,nice,lazyshift;..." to override the
variant list.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_inflate import make_payload  # noqa: E402

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "image_stitch_tpu", "native", "stitchnative.cpp",
)

DEFAULT_VARIANTS = (
    "base=8,24,96,2;"
    "chain6=6,24,96,2;"
    "chain4=4,24,96,2;"
    "nice48=8,24,48,2;"
    "lazy12=8,12,96,2;"
    "shift3=8,24,96,3;"
    "fastest=4,12,48,3"
)


def build_variant(name: str, chain: int, maxlazy: int, nice: int,
                  shift: int) -> str:
    path = os.path.join(tempfile.gettempdir(), f"defl_sweep_{name}.so")
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        f"-DDEFL_L6_CHAIN={chain}", f"-DDEFL_L6_MAXLAZY={maxlazy}",
        f"-DDEFL_L6_NICE={nice}", f"-DDEFL_L6_LAZYSHIFT={shift}",
        "-o", path, SRC,
    ]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    return path


def load_lib(path: str):
    lib = ctypes.CDLL(path)
    lib.owned_deflate_batch.restype = ctypes.c_int64
    lib.owned_deflate_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.owned_deflate_scratch_size.restype = ctypes.c_int64
    lib.owned_deflate_scratch_size.argtypes = []
    lib.owned_deflate_warmup.restype = None
    lib.owned_deflate_warmup.argtypes = []
    lib.owned_deflate_warmup()
    return lib


def main() -> None:
    size_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 24.0
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    spec = os.environ.get("SWEEP_DEFL", DEFAULT_VARIANTS)

    variants = []
    for item in spec.split(";"):
        name, params = item.split("=")
        chain, maxlazy, nice, shift = (int(x) for x in params.split(","))
        t0 = time.perf_counter()
        path = build_variant(name, chain, maxlazy, nice, shift)
        print(f"built {name} ({params}) in {time.perf_counter()-t0:.0f}s",
              flush=True)
        variants.append((name, load_lib(path)))

    payload = make_payload("bench", size_mb)
    mb = len(payload) / 1e6
    z6 = len(zlib.compress(payload, 6))
    print(f"payload {mb:.1f} MB, zlib-6 -> {z6/1e6:.3f} MB "
          f"({z6/len(payload)*100:.2f}%)", flush=True)

    # Contiguous [data | 8 zero slack] input; hist_len 0, one final batch.
    # HOLD the arrays — closures capturing only .ctypes.data let numpy
    # free the buffer under running C code (round-4 hard-won fact).
    buf = np.zeros(len(payload) + 8, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    cap = len(payload) + len(payload) // 32 + 4096

    sizes = {}
    results = {name: [] for name, _ in variants}
    out_arrs = {name: np.empty(cap, dtype=np.uint8) for name, _ in variants}
    scratch = None
    for name, lib in variants:
        ssz = int(lib.owned_deflate_scratch_size())
        if scratch is None or len(scratch) < ssz:
            scratch = np.zeros(ssz, dtype=np.uint8)

    for r in range(rounds):
        for name, lib in variants:
            out = out_arrs[name]
            t0c = time.process_time()
            t0w = time.perf_counter()
            n = lib.owned_deflate_batch(
                buf.ctypes.data, 0, len(payload), 1, 6,
                out.ctypes.data, cap, scratch.ctypes.data,
            )
            dtc = time.process_time() - t0c
            dtw = time.perf_counter() - t0w
            assert n > 0, name
            if r == 0:
                raw = out[: int(n)].tobytes()
                got = zlib.decompressobj(-15).decompress(raw)
                assert got == payload, f"{name}: roundtrip mismatch"
                sizes[name] = int(n)
            results[name].append((dtc, dtw))
            print(f"r{r} {name}: {mb/dtc:6.1f} MB/s cpu "
                  f"({mb/dtw:6.1f} wall)", flush=True)

    base = variants[0][0]
    print("\n== summary (best-of CPU-time; size vs zlib-6) ==")
    for name, _ in variants:
        best = min(c for c, _ in results[name])
        ratios = [
            results[name][i][0] / results[base][i][0] for i in range(rounds)
        ]
        print(
            f"{name:8s}: {mb/best:6.1f} MB/s  size {sizes[name]/1e6:.3f} MB "
            f"({(sizes[name]/z6-1)*100:+.2f}% vs zlib-6)  "
            f"time vs {base}: " + " ".join(f"{x:.2f}" for x in ratios)
        )


if __name__ == "__main__":
    main()
