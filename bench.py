#!/usr/bin/env python
"""End-to-end throughput benchmarks for the BASELINE.md configs.

Default (headline, what the driver records): BENCH_CONFIG=grid_jpeg —
an N x N grid of PNG tiles -> JPEG q85 through the full pipeline
(streaming PNG decode -> band compositing -> DCT/quantize -> entropy ->
bytes). Other configs: png_out, jpeg_tiles, positioned, pngsuite.

Env knobs: BENCH_CONFIG, BENCH_GRID, BENCH_TILE, BENCH_BACKEND, BENCH_BAND,
BENCH_THREADS (host decode worker threads; >1 pays off on multi-core hosts).
Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} where
vs_baseline is the fraction of the 1 GP/s/chip north-star target.

Backend: BENCH_BACKEND (default numpy, the host C++ tier; jax runs the
device pipeline; auto applies the library's own rule). One process per
card: the config sweep below runs in child processes only when this
process has not put work on the device.
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CONFIG = os.environ.get("BENCH_CONFIG", "grid_jpeg")
GRID = int(os.environ.get("BENCH_GRID", "8"))
TILE = int(os.environ.get("BENCH_TILE", "1024"))
if CONFIG == "northstar":
    # BASELINE.md config 5: 16x16 grid of 4K tiles -> JPEG q85 streaming,
    # O(canvas_width) memory asserted during the run. 4K = 3840 (UHD):
    # 16 x 4096 would be 65536 px, one past JPEG's 16-bit SOF dimension
    # cap (T.81 B.2.2), so the spec'd config is only encodable at UHD.
    GRID = int(os.environ.get("BENCH_GRID", "16"))
    TILE = int(os.environ.get("BENCH_TILE", "3840"))
QUALITY = 85
TARGET_MPPS = 1000.0  # 1 GP/s/chip north-star


def monitor_rss(fn):
    """Run fn while sampling RSS; returns (result, peak_delta_bytes)."""
    import threading

    def rss() -> int:
        with open(f"/proc/{os.getpid()}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    baseline = rss()
    peak = baseline
    stop = threading.Event()

    def sampler():
        nonlocal peak
        while not stop.is_set():
            peak = max(peak, rss())
            stop.wait(0.05)

    t = threading.Thread(target=sampler, daemon=True)
    t.start()
    try:
        result = fn()
    finally:
        stop.set()
        t.join(timeout=2.0)
    peak = max(peak, rss())
    return result, max(0, peak - baseline)


def make_tile_png(seed: int, size: int) -> bytes:
    """A photo-like tile: smooth gradients + structured noise, RGBA8 PNG."""
    import zlib

    from image_stitch_tpu import PngHeader, build_png
    from image_stitch_tpu.ops.png_filter import filter_select_band

    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, size, dtype=np.float32)
    arr = np.empty((size, size, 4), dtype=np.uint8)
    arr[:, :, 0] = (x[None, :] * 0.7 + x[:, None] * 0.3).astype(np.uint8)
    arr[:, :, 1] = (x[:, None]).astype(np.uint8)
    arr[:, :, 2] = rng.integers(0, 64, (size, size), dtype=np.uint8) + 96
    arr[:, :, 3] = 255
    raw = arr.reshape(size, size * 4)
    types, filtered = filter_select_band(raw, None, 4)
    payload = np.empty((size, 1 + size * 4), dtype=np.uint8)
    payload[:, 0] = types
    payload[:, 1:] = filtered
    return build_png(
        PngHeader(width=size, height=size, bit_depth=8, color_type=6),
        zlib.compress(payload.tobytes(), 6),
    )


def make_tile_jpeg(seed: int, size: int) -> bytes:
    from image_stitch_tpu import encode_jpeg

    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, size, dtype=np.float32)
    arr = np.empty((size, size, 4), dtype=np.uint8)
    arr[:, :, 0] = (x[None, :]).astype(np.uint8)
    arr[:, :, 1] = (x[:, None] * 0.8).astype(np.uint8)
    arr[:, :, 2] = rng.integers(64, 192, (size, size), dtype=np.uint8)
    arr[:, :, 3] = 255
    return encode_jpeg(arr, size, size, quality=90)


def band_pixels(h: int, w: int, seed0: int = 0) -> np.ndarray:
    """(h, w, 4) RGBA8: the top h rows of w // 1024 side-by-side 1024-px
    make_tile_png tiles (seeds seed0, seed0 + 1, ...), without the PNG
    round trip."""
    size = 1024
    x = np.linspace(0, 255, size, dtype=np.float32)
    tiles = []
    for t in range(w // size):
        rng = np.random.default_rng(seed0 + t)
        arr = np.empty((size, size, 4), dtype=np.uint8)
        arr[:, :, 0] = (x[None, :] * 0.7 + x[:, None] * 0.3).astype(np.uint8)
        arr[:, :, 1] = (x[:, None]).astype(np.uint8)
        arr[:, :, 2] = rng.integers(0, 64, (size, size), dtype=np.uint8) + 96
        arr[:, :, 3] = 255
        tiles.append(arr[:h])
    return np.concatenate(tiles, axis=1)


def make_positioned_inputs(side: int):
    """A side x side PNG background plus 50 alpha sprites at seeded
    positions and z-indices. Returns (inputs, side)."""
    from image_stitch_tpu import PositionedImage

    bg = make_tile_png(0, side)
    rng = np.random.default_rng(0)
    sprite = make_tile_png(1, max(64, side // 16))
    inputs = [PositionedImage(x=0, y=0, source=bg)]
    for _ in range(50):
        inputs.append(
            PositionedImage(
                x=int(rng.integers(0, side - 64)),
                y=int(rng.integers(0, side - 64)),
                source=sprite,
                z_index=int(rng.integers(0, 10)),
            )
        )
    return inputs, side


def run_streaming(opts) -> tuple[float, float, int]:
    """One timed pass. Returns (wall_s, cpu_s, out_bytes): cpu_s is
    process CPU time, which neighbours on a shared host disturb less than
    the wall clock."""
    from image_stitch_tpu import concat_streaming

    t0 = time.perf_counter()
    c0 = time.process_time()
    out_bytes = 0
    for chunk in concat_streaming(opts):
        out_bytes += len(chunk)
    return time.perf_counter() - t0, time.process_time() - c0, out_bytes


def build_config(backend: str):
    band = int(os.environ.get("BENCH_BAND", "512"))
    base = {"backend": backend, "band_height": band}
    restart = int(os.environ.get("BENCH_RESTART", "0"))
    if restart:
        base["jpeg_restart_interval_rows"] = restart
    threads = int(os.environ.get("BENCH_THREADS", "0"))
    if threads:
        base["host_threads"] = threads  # parallel per-tile decode pulls
    if CONFIG == "northstar":
        # 4 unique 4K tiles reused across the 16x16 grid (tile generation
        # would otherwise dominate setup); JPEG q85 via streaming output.
        # The tile reuse is a SETUP artifact, so the factory's default
        # decode-once sharing is disabled: the metric means "decode 256
        # tiles", and the cache would legitimately skip 252 of them.
        os.environ.setdefault("STITCH_TPU_AUTO_CACHE_MB", "0")
        tiles = [make_tile_png(s, TILE) for s in range(4)]
        inputs = [tiles[i % len(tiles)] for i in range(GRID * GRID)]
        opts = {**base, "inputs": inputs, "layout": {"columns": GRID},
                "outputFormat": "jpeg", "jpegQuality": QUALITY}
        warm = {**opts, "inputs": inputs[:GRID]}
        mp = (GRID * TILE) ** 2 / 1e6
        name = (f"northstar: {GRID}x{GRID} grid of {TILE}px PNG tiles -> "
                f"JPEG q{QUALITY} (streaming)")
    elif CONFIG == "grid_jpeg":
        # Every tile UNIQUE: the headline measures GRID*GRID real decodes.
        # (With repeated tiles the factory's default decode-once sharing
        # would legitimately skip 7/8 of the decode work — a different,
        # easier workload. Generation happens outside the timed region.)
        inputs = [make_tile_png(s, TILE) for s in range(GRID * GRID)]
        opts = {**base, "inputs": inputs, "layout": {"columns": GRID},
                "outputFormat": "jpeg", "jpegQuality": QUALITY}
        warm = {**opts, "inputs": inputs[:GRID]}
        mp = (GRID * TILE) ** 2 / 1e6
        name = f"{GRID}x{GRID} grid of {TILE}px PNG tiles -> JPEG q{QUALITY}"
    elif CONFIG == "png_out":
        # Unique tiles: the metric includes GRID*GRID real decodes (see
        # grid_jpeg note; decode-once sharing would skip duplicates).
        inputs = [make_tile_png(s, TILE) for s in range(GRID * GRID)]
        opts = {**base, "inputs": inputs, "layout": {"columns": GRID}}
        warm = {**opts, "inputs": inputs[:GRID]}
        mp = (GRID * TILE) ** 2 / 1e6
        name = f"{GRID}x{GRID} grid of {TILE}px PNG tiles -> PNG (level 6)"
    elif CONFIG == "jpeg_tiles":
        # Unique tiles: 16 real JPEG decodes (decode-once sharing would
        # otherwise collapse the repeats to 4).
        inputs = [make_tile_jpeg(s, TILE) for s in range(16)]
        opts = {**base, "inputs": inputs, "layout": {"columns": 4},
                "outputFormat": "jpeg", "jpegQuality": QUALITY}
        warm = {**opts, "inputs": inputs[:4]}
        mp = (4 * TILE) ** 2 / 1e6
        name = f"4x4 grid of {TILE}px JPEG tiles -> JPEG q{QUALITY}"
    elif CONFIG == "positioned":
        inputs, side = make_positioned_inputs(GRID * TILE // 4)
        opts = {**base, "inputs": inputs, "layout": {"width": side, "height": side}}
        fmt = os.environ.get("BENCH_FORMAT", "png")
        if fmt == "jpeg":
            # Fused positioned->JPEG: composite + quantize + entropy all
            # on-device; only compressed bits come back to the host.
            opts.update({"outputFormat": "jpeg", "jpegQuality": QUALITY})
        warm = {**opts, "inputs": inputs[:3]}
        mp = side * side / 1e6
        name = (f"positioned: background + 50 alpha sprites ({side}px) "
                f"-> {fmt.upper()}")
    elif CONFIG == "pair_png":
        # BASELINE.md config 1: 2x1 grid of two 512px RGBA8 PNGs -> PNG via
        # concat_to_buffer (the CPU reference path).
        tiles = [make_tile_png(s, 512) for s in range(2)]
        opts = {**base, "inputs": tiles, "layout": {"columns": 2}}
        warm = dict(opts)
        mp = 2 * 512 * 512 / 1e6
        name = "pair: 2x1 grid of 512px PNG tiles -> PNG"
    elif CONFIG == "pngsuite":
        suite = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "fixtures", "pngsuite")
        names = sorted(
            n for n in os.listdir(suite)
            if n.endswith(".png") and not n.startswith("x")
        )
        inputs = [os.path.join(suite, n) for n in names] * 4
        opts = {**base, "inputs": inputs, "layout": {"columns": 16},
                "outputFormat": "jpeg", "jpegQuality": QUALITY}
        warm = {**opts, "inputs": inputs[:16]}
        mp = len(inputs) * 32 * 32 / 1e6  # approx: suite tiles are 32x32
        name = f"pngsuite sweep x4 ({len(inputs)} mixed-format tiles) -> JPEG"
    else:
        raise SystemExit(f"unknown BENCH_CONFIG: {CONFIG}")
    return name, opts, warm, mp


def other_configs_subprocess() -> dict:
    """Run the non-headline BASELINE.md configs (pair_png, png_out,
    jpeg_tiles, positioned, pngsuite, northstar) at reps 1-2 in child
    processes with time budgets, on the host backend. Each row reports
    {mps, cpu_mps, seconds}; failures degrade to a skip reason."""
    import subprocess
    import sys

    rows: dict[str, object] = {}
    base_env = dict(os.environ)
    plans = (
        ("pair_png", "2", 120.0),
        ("png_out", "2", 600.0),
        ("jpeg_tiles", "2", 300.0),
        ("positioned", "2", 600.0),
        ("pngsuite", "2", 300.0),
        ("northstar", "1", 900.0),
    )
    for config, reps, budget in plans:
        env = dict(base_env)
        env.update({"BENCH_CONFIG": config, "BENCH_REPS": reps})
        budget = float(os.environ.get("BENCH_OTHER_BUDGET_S", str(budget)))
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__)],
                capture_output=True, text=True, timeout=budget, env=env,
            )
            row = json.loads(out.stdout.strip().splitlines()[-1])
            rows[config] = {
                "mps": row["value"],
                "cpu_mps": row["detail"].get("cpu_mps"),
                "seconds": row["detail"].get("seconds"),
            }
        except subprocess.TimeoutExpired:
            rows[config] = {"skipped": f"exceeded {budget:.0f}s budget"}
        except Exception as exc:  # noqa: BLE001 - report, don't crash
            rows[config] = {"skipped": f"failed: {type(exc).__name__}"}
    return rows


def main() -> None:
    from image_stitch_tpu.ops.backend import resolve_backend_name

    backend = resolve_backend_name(os.environ.get("BENCH_BACKEND", "numpy"))
    name, opts, warm, mp = build_config(backend)

    default_reps = "1" if CONFIG == "northstar" else "5"
    reps = int(os.environ.get("BENCH_REPS", default_reps))
    peak_delta = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_streaming(warm)  # compile outside the timed region
        # Best-of-N: the best run reflects the pipeline, the spread reflects
        # neighbours on the host.
        if CONFIG == "northstar":
            runs, peak_delta = monitor_rss(
                lambda: [run_streaming(opts) for _ in range(reps)]
            )
        else:
            runs = [run_streaming(opts) for _ in range(reps)]
        dt, _, out_bytes = min(runs, key=lambda r: r[0])
        cpu_dt = min(r[1] for r in runs)

    mpps = mp / dt
    detail = {
        "config": CONFIG,
        "megapixels": round(mp, 1),
        "seconds": round(dt, 3),
        "output_bytes": out_bytes,
        "backend": backend,
        "best_of": reps,
        "all_seconds": [round(r[0], 3) for r in runs],
        # Load-immune host rate: megapixels per CPU-second. On the host
        # backend this is THE comparable round-over-round number; on the
        # device backend it reports host-side CPU cost only (device wait
        # burns no CPU), so read it as orchestration overhead there.
        "cpu_seconds": round(cpu_dt, 3),
        "cpu_mps": round(mp / cpu_dt, 2) if cpu_dt > 0 else None,
    }
    if peak_delta is not None:
        # The O(canvas_width) contract: peak RSS during the streamed run
        # stays in the band-working-set class, nowhere near the canvas
        # (canvas = GRID*TILE squared * 4 bytes).
        canvas_bytes = (GRID * TILE) ** 2 * 4
        detail["peak_rss_delta_mb"] = round(peak_delta / 1e6, 1)
        detail["canvas_mb"] = round(canvas_bytes / 1e6, 1)
        detail["o_canvas_width_ok"] = bool(peak_delta < canvas_bytes / 4)

    detail["backends"] = {backend: round(mpps, 2)}

    # The other configs ride the headline line. They run in child
    # processes, so only when this process left the device alone: a second
    # process cannot open a card the first one holds.
    if CONFIG == "grid_jpeg" and os.environ.get("BENCH_OTHER_CONFIGS", "1") != "0":
        if backend == "numpy":
            detail["other_configs"] = other_configs_subprocess()
        else:
            detail["other_configs"] = {
                "skipped": "the device backend holds the card in this process"
            }

    result = {
        "metric": f"{name} (MP/s/chip, end-to-end)",
        "value": round(mpps, 2),
        "unit": "MP/s",
        "vs_baseline": round(mpps / TARGET_MPPS, 4),
        "detail": detail,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
