#!/usr/bin/env python
"""Smoke test of the stitch pipeline on an NVIDIA GPU.

    python chip_smoke.py              # phases 0-5 on one GPU
    python chip_smoke.py --devices 4  # only the mesh path (mesh=4), on 4 GPUs

Every phase drives the public streaming API (``concat_streaming``) at the
sizes users stitch with ``backend="jax"`` (or ``mesh=4``), runs once to
compile, times a second (warm) run, and compares the output byte for byte
with the same call under ``backend="numpy"`` (the host tier, this system's
reference: the pipeline is integer end to end, so any differing byte is a
failure). The default ``backend="auto"`` is the host tier, so the device
is named. Each phase prints one line with its evidence that the device did
the work: the device-program counters of the run.

The last line of standard output is one JSON object, printed only when
every phase passed:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Any failure, or a machine without a GPU, exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GRID = 8  # phases 1-2: GRID x GRID unique TILE-px PNG tiles (67 MP canvas)
JPEG_GRID = 4  # phase 3: JPEG_GRID x JPEG_GRID TILE-px JPEG tiles
TILE = 1024
POSITIONED_SIDE = 2048  # phase 4: background side, plus 50 sprites
BAND = 512  # rows per band: 512 x 8192 px = 4.2 MP per band in phases 1-2
KERNEL_WIDTH = 8192  # phase 5: stage programs at a BAND x KERNEL_WIDTH band
QUALITY = 85


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--devices", type=int, default=1, choices=(1, 4),
        help="1: phases 0-5 on one GPU; 4: the mesh path on four GPUs only",
    )
    return p.parse_args(argv)


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def run(opts) -> tuple[bytes, float, dict]:
    """One concat_streaming pass: (bytes, seconds, counter deltas)."""
    from image_stitch_tpu import concat_streaming
    from image_stitch_tpu.utils.observability import COUNTERS

    before = dict(COUNTERS)
    t0 = time.perf_counter()
    out = b"".join(concat_streaming(opts))
    dt = time.perf_counter() - t0
    delta = {k: v - before.get(k, 0) for k, v in COUNTERS.items()
             if v != before.get(k, 0)}
    return out, dt, delta


def phase(name: str, opts: dict, expect: dict, mesh: int | None = None) -> None:
    """Compile run, warm run, host-reference run; check bytes and evidence.

    ``expect`` maps a counter to the least count the warm run must show."""
    if mesh is not None:
        chosen = f"mesh={mesh}"
        dev_opts = {**opts, "mesh": mesh}
    else:
        chosen = "jax"
        dev_opts = {**opts, "backend": "jax"}
    run(dev_opts)  # compile
    out, warm_s, counters = run(dev_opts)
    ref, host_s, _ = run({**opts, "backend": "numpy"})
    check(out == ref, f"{name}: {len(out)} device bytes differ from the "
          f"{len(ref)} host bytes")
    for key, least in expect.items():
        check(counters.get(key, 0) >= least,
              f"{name}: counter {key}={counters.get(key, 0)} < {least}")
    import jax

    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(
        f"phase {name}: bytes={len(out)} identical_to_host=True "
        f"warm_s={warm_s:.3f} host_tier_s={host_s:.3f} backend={chosen} "
        f"host_fallback_bands={counters.get('jpeg_host_fallback_bands', 0)} "
        f"counters={json.dumps(counters, sort_keys=True)} "
        f"peak_device_bytes={peak}",
        flush=True,
    )


def grid_png_tiles(grid: int, size: int) -> list[bytes]:
    from bench import make_tile_png

    return [make_tile_png(s, size) for s in range(grid * grid)]


def phase_device(n_devices: int):
    import jax

    backend = jax.default_backend()
    check(backend == "gpu", f"device: JAX default backend is {backend!r}, not 'gpu'")
    devices = jax.devices()
    check(len(devices) >= n_devices,
          f"device: {len(devices)} devices visible, {n_devices} needed")
    from image_stitch_tpu.native import native_available

    print(gpu_name_and_power_limit(), flush=True)
    print(
        f"phase device: jax={jax.__version__} devices={devices} "
        f"native_host_tier={native_available()}",
        flush=True,
    )
    return devices


def phase_kernels() -> None:
    """Each device stage program alone at a BAND x KERNEL_WIDTH q85 4:4:4 band,
    compiled for the card and compared exactly with its plain reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import band_pixels
    from image_stitch_tpu.codecs.jpeg.encoder import _band_to_blocks_numpy
    from image_stitch_tpu.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu.ops.device import filter_select_trace, jpeg_quantize_trace
    from image_stitch_tpu.ops.png_filter import filter_select_band

    rgba = band_pixels(BAND, KERNEL_WIDTH)
    lq, cq = quality_scaled_tables(QUALITY)
    checked = []

    raw = rgba.reshape(BAND, -1)
    fjit = jax.jit(filter_select_trace, static_argnames=("bpp",))
    types, filtered, _ = fjit(jnp.asarray(raw), jnp.zeros(raw.shape[1], jnp.uint8), 4)
    exp_t, exp_f = filter_select_band(raw, None, 4)
    check(np.array_equal(np.asarray(types), exp_t)
          and np.array_equal(np.asarray(filtered), exp_f),
          "kernels: filter select differs from the host reference")
    checked.append("png_filter_select")

    blocks = jax.jit(jpeg_quantize_trace)(jnp.asarray(rgba), jnp.asarray(lq), jnp.asarray(cq))
    exp = _band_to_blocks_numpy(rgba, lq, cq)
    check(all(np.array_equal(np.asarray(a), b) for a, b in zip(blocks, exp)),
          "kernels: DCT/quantize differs from the host reference")
    checked.append("jpeg_dct_quantize")

    # Phase-1 pack: the Pallas kernel compiled through Triton against the
    # plain XLA form, on the band's real symbol streams (q85 budget).
    from image_stitch_tpu.codecs.jpeg.huffman import build_huffman_codes
    from image_stitch_tpu.codecs.jpeg import tables as T
    from image_stitch_tpu.ops.jpeg_entropy_device import (
        _pack_blocks_aligned,
        _symbol_streams_flat,
        build_entropy_luts,
    )
    from image_stitch_tpu.ops.pallas_kernels import pack_blocks_aligned_pallas

    luts = build_entropy_luts(
        build_huffman_codes(T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS),
        build_huffman_codes(T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS),
        build_huffman_codes(T.STD_DC_CHROMA_BITS, T.STD_DC_CHROMA_VALS),
        build_huffman_codes(T.STD_AC_CHROMA_BITS, T.STD_AC_CHROMA_VALS),
    )
    codes, lens = jax.jit(_symbol_streams_flat, static_argnums=(4,))(
        *blocks, luts, BAND // 8
    )
    bits = jnp.sum(lens, axis=1)
    starts = (jnp.cumsum(bits) - bits).astype(jnp.int32)
    ref = jax.jit(_pack_blocks_aligned, static_argnums=(3, 4))(
        codes, lens, starts, 12, False
    )
    got = pack_blocks_aligned_pallas(codes, lens, starts, 12, interpret=False)
    check(np.array_equal(np.asarray(got), np.asarray(ref)),
          "kernels: Pallas pack kernel differs from the XLA form")
    checked.append(f"pallas_pack_blocks(nb={codes.shape[0]})")
    print(f"phase kernels: shape=({BAND}, {KERNEL_WIDTH}) exact={checked}", flush=True)


def single_card() -> None:
    from bench import make_tile_jpeg, make_positioned_inputs

    tiles = grid_png_tiles(GRID, TILE)
    grid = {"inputs": tiles, "layout": {"columns": GRID}, "bandHeight": BAND}
    side = GRID * TILE
    jpeg = {"outputFormat": "jpeg", "jpegQuality": QUALITY}
    for ri in (0, 1):
        phase(f"grid_jpeg(restart_rows={ri})",
              {**grid, **jpeg, "jpeg_restart_interval_rows": ri},
              {"device_jpeg_programs": 1})
    phase("png_out", grid, {"device_png_filter_bands": -(-side // BAND)})

    jtiles = [make_tile_jpeg(s, TILE) for s in range(JPEG_GRID * JPEG_GRID)]
    side = JPEG_GRID * TILE
    phase("jpeg_tiles",
          {"inputs": jtiles, "layout": {"columns": JPEG_GRID}, "bandHeight": BAND,
           **jpeg},
          {"device_decode_bands": -(-side // BAND), "device_jpeg_programs": 1})

    inputs, side = make_positioned_inputs(POSITIONED_SIDE)
    pos = {"inputs": inputs, "layout": {"width": side, "height": side},
           "bandHeight": BAND}
    phase("positioned_png", pos,
          {"device_composite_bands": 1, "device_png_filter_bands": 1})
    phase("positioned_jpeg", {**pos, **jpeg},
          {"device_composite_bands": 1, "device_jpeg_programs": 1})
    phase_kernels()


def mesh_path(n: int) -> None:
    tiles = grid_png_tiles(GRID, TILE)
    grid = {"inputs": tiles, "layout": {"columns": GRID}, "bandHeight": BAND}
    side = GRID * TILE
    phase("mesh_grid_jpeg(restart_rows=1)",
          {**grid, "outputFormat": "jpeg", "jpegQuality": QUALITY,
           "jpeg_restart_interval_rows": 1},
          {"device_jpeg_programs": 1}, mesh=n)
    phase("mesh_png_out", grid,
          {"device_png_filter_bands": -(-side // BAND)}, mesh=n)
    mesh_pack_sharded(n)


def mesh_pack_sharded(n: int) -> None:
    """The restart-groups band program compiled for the n-device mesh: each
    device's Triton pack call must cover nb / n blocks, not all nb."""
    import functools
    import re

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bench import band_pixels
    from image_stitch_tpu.codecs.jpeg import tables as T
    from image_stitch_tpu.codecs.jpeg.huffman import build_huffman_codes
    from image_stitch_tpu.codecs.jpeg.tables import quality_scaled_tables
    from image_stitch_tpu.ops.jpeg_entropy_device import (
        build_entropy_luts,
        jpeg_encode_band_groups_trace,
    )
    from image_stitch_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n)
    lq, cq = quality_scaled_tables(QUALITY)
    luts = build_entropy_luts(
        build_huffman_codes(T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS),
        build_huffman_codes(T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS),
        build_huffman_codes(T.STD_DC_CHROMA_BITS, T.STD_DC_CHROMA_VALS),
        build_huffman_codes(T.STD_AC_CHROMA_BITS, T.STD_AC_CHROMA_VALS),
    )
    rep = NamedSharding(mesh, P())
    prog = jax.jit(
        functools.partial(
            jpeg_encode_band_groups_trace, n_groups=BAND // 8,
            cap_words=8 * KERNEL_WIDTH * 3 // 32, local_words=12,  # q85
            merge="hybrid", mesh=mesh,
        ),
        in_shardings=(NamedSharding(mesh, P("band", "x", None)), rep, rep,
                      {k: rep for k in luts}),
    )
    band = jnp.asarray(band_pixels(BAND, KERNEL_WIDTH)[..., :3])
    hlo = prog.lower(band, jnp.asarray(lq), jnp.asarray(cq), luts).compile().as_text()
    nb = BAND * KERNEL_WIDTH // 64 * 3
    words = (12 + 2) * nb
    calls = [ln for ln in hlo.splitlines() if "custom-call(" in ln and "triton" in ln]
    shapes = sorted({int(m) for ln in calls
                     for m in re.findall(r"= u32\[(\d+)\]", ln)})
    check(shapes == [words // n],
          f"mesh pack: Triton call output sizes {shapes}, expected "
          f"[{words // n}] (nb={nb} blocks over {n} devices); "
          f"calls: {[ln.strip()[:300] for ln in calls][:4]}")
    print(f"phase mesh_pack_sharded: blocks={nb} per_device={nb // n} "
          f"triton_out_words={shapes}", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        devices = phase_device(args.devices)
        if args.devices == 1:
            single_card()
        else:
            mesh_path(args.devices)
    except SmokeFailure as exc:
        print(f"FAIL {exc}", flush=True)
        return 1
    print(result_line(devices[0].platform, devices[0].device_kind, len(devices)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
