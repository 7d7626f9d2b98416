#!/usr/bin/env python
"""A/B timings of the device program forms on an NVIDIA GPU.

    python scripts/ab_device_forms.py forms [--tree DIR]
    python scripts/ab_device_forms.py rss [--tree DIR] [--no-delete]
    python scripts/ab_device_forms.py e2e [--grids 1,2,4,8]

``forms``: device busy time per 512 x 8192 q85 4:4:4 band (the union of
kernel intervals on the GPU stream lines of a ``jax.profiler`` trace taken
through ``utils.observability.device_trace``, divided by the calls) of the
restart-groups band program with each alternative form swapped in, of the
phase-1 pack alone (Triton kernel vs the XLA ``fori_loop``), and of PNG
filter selection, whose compiled HLO is also searched for a (5, H, N)
candidate tensor. Runs are interleaved A, B, B, A; every variant's outputs
are checked against the base program's.

``rss``: peak host RSS growth and peak device bytes of the 67 MP grid_jpeg
run (8 x 8 1024-px PNG tiles to JPEG q85, restart rows 0 and 1) on the
device and on the host tier. ``--no-delete`` turns the encoder's explicit
device-buffer frees (``_delete_arrays``, where the tree has them) into
no-ops.

``e2e``: warm seconds of ``concat_to_buffer`` on the device vs the host
tier for grids of 512-px PNG tiles to PNG and to JPEG, interleaved
host, device, device, host.

``--tree DIR`` imports ``image_stitch_tpu`` from another checkout, e.g. an
earlier commit unpacked with ``git archive <commit> | tar -x -C DIR``, so
forms that tree still has (one-hot matmul lookups, matmul ranks and
scatters, the int8 log-step scan) are timed in the same way. Results go
to stdout and, as JSON, to ``chiprun_out/ab_<mode>.json``.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import statistics
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 8192
BAND = 512
REPS = 10


def device_busy_ms(fn, reps: int = REPS):
    """(device ms per call, wall ms per call, top kernels) from a trace."""
    import jax

    from image_stitch_tpu.utils.observability import device_trace

    jax.block_until_ready(fn())  # warm
    log_dir = tempfile.mkdtemp()
    t0 = time.perf_counter()
    with device_trace(log_dir):
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / reps * 1e3
    path = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True)[0]
    intervals, per_kernel = [], {}
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                intervals.append((e.start_ns, e.end_ns))
                per_kernel[e.name] = per_kernel.get(e.name, 0) + e.duration_ns
    busy, cur = 0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            busy += cur[1] - cur[0] if cur else 0
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += cur[1] - cur[0] if cur else 0
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return busy / reps / 1e6, wall, [(k[:70], v / reps / 1e6) for k, v in top]


def band_rgb(seed0: int = 0):
    from bench import band_pixels

    return band_pixels(BAND, W, seed0)[..., :3]


def entropy_luts(E):
    from image_stitch_tpu.codecs.jpeg import tables as T
    from image_stitch_tpu.codecs.jpeg.huffman import build_huffman_codes

    return E.build_entropy_luts(
        build_huffman_codes(T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS),
        build_huffman_codes(T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS),
        build_huffman_codes(T.STD_DC_CHROMA_BITS, T.STD_DC_CHROMA_VALS),
        build_huffman_codes(T.STD_AC_CHROMA_BITS, T.STD_AC_CHROMA_VALS),
    )


def forms(results: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import image_stitch_tpu.ops.jpeg_entropy_device as E
    from image_stitch_tpu.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu.ops.device import filter_select_trace, jpeg_quantize_trace

    lq, cq = (jnp.asarray(t) for t in quality_scaled_tables(85))
    luts = entropy_luts(E)
    band = jnp.asarray(band_rgb())

    def xla_pack(codes, lens, starts, local_words, transpose=True, mesh=None):
        return E._pack_blocks_aligned(codes, lens, starts, local_words, transpose)

    def cummax_scan(nz, pos):
        incl = jax.lax.cummax(jnp.where(nz, pos, 0), axis=1)
        return incl, jnp.pad(incl[:, :-1], ((0, 0), (1, 0))), incl[:, -1]

    source = open(E.__file__).read()
    kernel_source = os.path.join(os.path.dirname(E.__file__), "pallas_kernels.py")
    has_triton_pack = "triton" in open(kernel_source).read()
    # name -> (module attribute, replacement, does this tree have a
    # different form to swap in?)
    swaps = {
        "pack_xla": ("_pack_dispatch", xla_pack, has_triton_pack),
        "aclut_matmul": ("_ac_lut_lookup", getattr(E, "_ac_lut_lookup_matmul", None),
                         hasattr(E, "_ac_lut_lookup_matmul")),
        "zz_matmul": ("_zz_permute", getattr(E, "_zz_permute_matmul", None),
                      hasattr(E, "_zz_permute_matmul")),
        "cummax": ("_prev_nonzero_scan", cummax_scan,
                   "jax.lax.cummax(" not in source.split("def _prev_nonzero_scan")[1][:900]),
        "rank_matmul": ("_rank_sorted", getattr(E, "_rank_matmul", None),
                        hasattr(E, "_rank_matmul")),
        "scatter_matmul": ("_scatter_or_disjoint", getattr(E, "_scatter_or_matmul", None),
                           hasattr(E, "_scatter_or_matmul")),
    }
    variants = ["base"] + [v for v, (_, _, ok) in swaps.items() if ok]
    orig = {k: getattr(E, k) for k, _, _ in swaps.values() if hasattr(E, k)}

    def set_variant(v):
        for k, f in orig.items():
            setattr(E, k, f)
        if v != "base":
            k, r, _ = swaps[v]
            setattr(E, k, r)

    def groups_program():
        f = jax.jit(functools.partial(
            E.jpeg_encode_band_groups_trace, n_groups=BAND // 8,
            cap_words=8 * W * 3 // 32, sampling="444", local_words=12,
            merge="hybrid"))
        return lambda: f(band, lq, cq, luts)[:4]

    set_variant("base")
    ref = [np.asarray(a) for a in groups_program()()]
    for i, v in enumerate(variants + ["base"] + variants[:0:-1]):
        set_variant(v)
        fn = groups_program()
        if i < len(variants):
            same = all((np.asarray(a) == b).all() for a, b in zip(fn(), ref))
            results[f"exact/{v}"] = bool(same)
            print(f"[exact] groups program {v}: {same}", flush=True)
        record(results, f"groups/{v}/{i}", fn)
    set_variant("base")

    if has_triton_pack:
        yb, cbb, crb = jax.jit(jpeg_quantize_trace)(band, lq, cq)
        codes, lens = jax.jit(functools.partial(
            E._symbol_streams_flat, n_groups=BAND // 8, sampling="444"))(
            yb, cbb, crb, luts)
        bits = jnp.sum(lens, axis=1)
        starts = (jnp.cumsum(bits) - bits).astype(jnp.int32)
        xla = jax.jit(functools.partial(
            E._pack_blocks_aligned, local_words=12, transpose=False))
        kernel = jax.jit(functools.partial(
            E._pack_dispatch, local_words=12, transpose=False))
        same = bool((np.asarray(xla(codes, lens, starts))
                     == np.asarray(kernel(codes, lens, starts))).all())
        results["exact/pack_alone"] = same
        print(f"[exact] pack alone, nb={codes.shape[0]}: {same}", flush=True)
        for i, (nm, f) in enumerate([("xla", xla), ("dispatch", kernel),
                                     ("dispatch", kernel), ("xla", xla)]):
            record(results, f"pack/{nm}/{i}", lambda f=f: f(codes, lens, starts))

    rgba = np.concatenate([band_rgb(100), np.full((BAND, W, 1), 255, np.uint8)], -1)
    raw = jnp.asarray(rgba.reshape(BAND, -1))
    prev = jnp.zeros((raw.shape[1],), jnp.uint8)
    fjit = jax.jit(filter_select_trace, static_argnames=("bpp",))
    hlo = fjit.lower(raw, prev, 4).compile().as_text()
    stack = f"s32[5,{BAND},{raw.shape[1]}]"
    results["filter/hlo_has_candidate_stack"] = stack in hlo
    print(f"filter select HLO has {stack}: {stack in hlo}", flush=True)
    for i in range(2):
        record(results, f"filter/{i}", lambda: fjit(raw, prev, 4))


def record(results: dict, name: str, fn) -> None:
    dev, wall, top = device_busy_ms(fn)
    results[name] = {"device_ms": dev, "wall_ms": wall, "top": top}
    print(f"{name}: device {dev:.4f} ms/call, wall {wall:.4f} ms/call", flush=True)
    for k, v in top[:6]:
        print(f"    {v:9.4f} ms  {k}", flush=True)


def rss(results: dict, no_delete: bool) -> None:
    import jax

    import image_stitch_tpu.ops.jpeg_entropy_device as E
    from bench import make_tile_png
    from image_stitch_tpu import concat_streaming
    from image_stitch_tpu.utils.observability import _rss_bytes

    if no_delete and hasattr(E, "_delete_arrays"):
        E._delete_arrays = lambda *arrs: None
    results["tree_has_delete_arrays"] = hasattr(E, "_delete_arrays")
    results["deletes_disabled"] = no_delete
    tiles = [make_tile_png(s, 1024) for s in range(64)]

    def measured(opts):
        peak, done = [0], threading.Event()

        def sample():
            while not done.is_set():
                peak[0] = max(peak[0], _rss_bytes())
                time.sleep(0.002)

        base = _rss_bytes()
        sampler = threading.Thread(target=sample)
        sampler.start()
        t0 = time.perf_counter()
        size = sum(len(c) for c in concat_streaming(opts))
        dt = time.perf_counter() - t0
        done.set()
        sampler.join()
        return size, dt, max(0, peak[0] - base)

    for ri in (0, 1):
        for backend in ("jax", "numpy", "numpy", "jax"):
            opts = {"inputs": tiles, "layout": {"columns": 8}, "bandHeight": BAND,
                    "outputFormat": "jpeg", "jpegQuality": 85,
                    "jpeg_restart_interval_rows": ri, "backend": backend}
            measured(opts)  # compile / warm
            size, dt, grew = measured(opts)
            stats = jax.devices()[0].memory_stats() or {}
            row = {"bytes": size, "seconds": dt, "rss_growth_mb": grew / 1e6,
                   "device_bytes_in_use": stats.get("bytes_in_use"),
                   "device_peak_bytes": stats.get("peak_bytes_in_use")}
            results.setdefault(f"restart{ri}/{backend}", []).append(row)
            print(f"restart_rows={ri} {backend}: {json.dumps(row)}", flush=True)


def e2e(results: dict, grids: list[int]) -> None:
    from bench import make_tile_png
    from image_stitch_tpu import concat_to_buffer

    tiles = [make_tile_png(s, 512) for s in range(max(grids) ** 2)]
    for k in grids:
        for fmt in ("png", "jpeg"):
            opts = {"inputs": tiles[: k * k], "layout": {"columns": k}}
            if fmt == "jpeg":
                opts.update({"outputFormat": "jpeg", "jpegQuality": 85})
            row, outs = {"grid": k, "format": fmt, "mp": k * k * 512 * 512 / 1e6}, {}
            for be in ("numpy", "jax", "jax", "numpy"):
                o = {**opts, "backend": be}
                outs.setdefault(be, concat_to_buffer(o))  # warm
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    concat_to_buffer(o)
                    ts.append(time.perf_counter() - t0)
                row.setdefault(be, []).append(statistics.median(ts))
            row["identical"] = outs["numpy"] == outs["jax"]
            results[f"{fmt}/{k}x{k}"] = row
            print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("forms", "rss", "e2e"))
    p.add_argument("--tree", help="import image_stitch_tpu from this checkout")
    p.add_argument("--no-delete", action="store_true")
    p.add_argument("--grids", default="1,2,4,8")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import bench  # noqa: F401  (this tree's tile makers, whatever --tree says)

    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import jax

    print("devices", jax.devices(), "tree", args.tree or ROOT, flush=True)
    results: dict = {"tree": args.tree or "."}
    if args.mode == "forms":
        forms(results)
    elif args.mode == "rss":
        rss(results, args.no_delete)
    else:
        e2e(results, [int(g) for g in args.grids.split(",")])
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    tag = os.path.basename(os.path.normpath(args.tree)) if args.tree else "tree"
    name = f"ab_{args.mode}_{tag}{'_nodelete' if args.no_delete else ''}.json"
    with open(os.path.join(out, name), "w") as f:
        json.dump(results, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
