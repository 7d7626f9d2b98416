"""Native host kernels: build-on-first-use C++ library with ctypes bindings.

Replacement for the reference's native/WASM tier (SURVEY §2):
PNG defiltering (the byte-serial 2D recurrence) and the JPEG Huffman bit
packer (serial bitstream) — the two host-bound stages that bracket the
device compute. Falls back to the pure numpy implementations when the
toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "stitchnative.cpp")
# Built libraries live inside the checkout, keyed by source hash and host ISA.
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".native_build",
)
_LIB = None
_LIB_TRIED = False


class HuffTableC(ctypes.Structure):
    _fields_ = [
        ("dc_code", ctypes.c_uint32 * 16),
        ("dc_len", ctypes.c_uint8 * 16),
        ("ac_code", ctypes.c_uint32 * 256),
        ("ac_len", ctypes.c_uint8 * 256),
    ]


class HuffDecTableC(ctypes.Structure):
    _fields_ = [
        ("min_code", ctypes.c_int32 * 17),
        ("max_code", ctypes.c_int32 * 17),
        ("val_ptr", ctypes.c_int32 * 17),
        ("vals", ctypes.c_uint8 * 256),
    ]


class EntropyStateC(ctypes.Structure):
    _fields_ = [
        ("bits", ctypes.c_uint64),
        ("count", ctypes.c_int),
        ("prev_dc", ctypes.c_int32 * 3),
    ]


def _host_isa_fingerprint() -> str:
    """Short fingerprint of the host ISA. The library is compiled with
    -march=native; a build directory shared across heterogeneous machines
    must not load an ISA-incompatible .so (SIGILL) — same machine-feature-
    mismatch class ops/device.py guards against for the JAX compile cache."""
    import platform

    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(line.split(":", 1)[1].strip())
                    break
    except OSError:
        pass
    return hashlib.sha256(" ".join(parts).encode()).hexdigest()[:8]


def _build_library() -> str | None:
    """Compile the shared library into the build dir, keyed by source hash
    and host-ISA fingerprint."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    digest = f"{digest}-{_host_isa_fingerprint()}"
    cache_dir = _BUILD_DIR
    os.makedirs(cache_dir, exist_ok=True)
    lib_path = os.path.join(cache_dir, f"stitchnative-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    with tempfile.NamedTemporaryFile(suffix=".so", dir=cache_dir, delete=False) as tmp:
        tmp_path = tmp.name
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        "-o", tmp_path, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp_path, lib_path)
        return lib_path
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired):
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return None


def get_native_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if os.environ.get("STITCH_TPU_NO_NATIVE"):
        return None
    path = _build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.png_defilter_band.restype = ctypes.c_int
    lib.png_defilter_band.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    for name in ("jpeg_entropy_encode_444", "jpeg_entropy_encode_420"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(HuffTableC), ctypes.POINTER(HuffTableC),
            ctypes.POINTER(EntropyStateC), ctypes.c_void_p, ctypes.c_int64,
        ]
    lib.jpeg_entropy_flush.restype = ctypes.c_int64
    lib.jpeg_entropy_flush.argtypes = [
        ctypes.POINTER(EntropyStateC), ctypes.c_void_p,
    ]
    for name in ("composite_rgba8", "composite_rgba16"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.png_defilter_units.restype = ctypes.c_int
    lib.png_defilter_units.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.png_filter_select_band.restype = None
    lib.png_filter_select_band.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.jpeg_quant_band_444.restype = None
    lib.jpeg_quant_band_444.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.jpeg_quant_band_420.restype = None
    lib.jpeg_quant_band_420.argtypes = lib.jpeg_quant_band_444.argtypes
    for name in ("jpeg_quant_entropy_band_444", "jpeg_quant_entropy_band_420"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(HuffTableC), ctypes.POINTER(HuffTableC),
            ctypes.POINTER(EntropyStateC), ctypes.c_void_p, ctypes.c_int64,
        ]
    lib.owned_inflate.restype = ctypes.c_int64
    lib.owned_inflate.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.owned_inflate_init.restype = None
    lib.owned_inflate_init.argtypes = [ctypes.c_void_p]
    lib.owned_inflate_state_size.restype = ctypes.c_int64
    lib.owned_inflate_state_size.argtypes = []
    for name in ("owned_inflate_state", "owned_inflate_error"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p]
    lib.owned_inflate_in_pos.restype = ctypes.c_int64
    lib.owned_inflate_in_pos.argtypes = [ctypes.c_void_p]
    lib.owned_inflate_stream_adler.restype = ctypes.c_uint32
    lib.owned_inflate_stream_adler.argtypes = [ctypes.c_void_p]
    lib.owned_inflate_rebase.restype = None
    lib.owned_inflate_rebase.argtypes = [ctypes.c_void_p]
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
    lib.jpeg_decode_scan.restype = ctypes.c_int
    lib.jpeg_decode_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(HuffDecTableC), ctypes.POINTER(HuffDecTableC),
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.stitch_adler32.restype = ctypes.c_uint32
    lib.stitch_adler32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
    for fn in (lib.stitch_rgb_to_rgba, lib.stitch_gray_to_rgba):
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.jpeg_decode_progressive_scan.restype = ctypes.c_int
    lib.jpeg_decode_progressive_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(HuffDecTableC), ctypes.POINTER(HuffDecTableC),
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.jpeg_idct_plane.restype = None
    lib.jpeg_idct_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.jpeg_ycc_rgb.restype = None
    lib.jpeg_ycc_rgb.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    for name in ("jpeg_h2v1_upsample", "jpeg_h2v2_upsample"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return get_native_lib() is not None


def adler32_native(data, initial: int = 1) -> int | None:
    """AVX2 Adler-32, zlib.adler32-compatible; None when unavailable."""
    lib = get_native_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else data
    return int(lib.stitch_adler32(buf.ctypes.data, buf.size, initial & 0xFFFFFFFF))


def expand_to_rgba_native(src: np.ndarray, channels: int) -> np.ndarray | None:
    """(N, channels) or flat uint8 RGB/gray -> (N, 4) RGBA with alpha 255
    via the AVX2 expanders; None when the native tier is unavailable.

    ``src`` must be C-contiguous uint8; ``channels`` is 3 (RGB) or 1
    (gray). The output is a fresh array shaped (n_px, 4)."""
    lib = get_native_lib()
    if lib is None:
        return None
    if src.dtype != np.uint8 or not src.flags.c_contiguous:
        src = np.ascontiguousarray(src, dtype=np.uint8)
    n_px = src.size // channels
    out = np.empty((n_px, 4), dtype=np.uint8)
    fn = lib.stitch_rgb_to_rgba if channels == 3 else lib.stitch_gray_to_rgba
    fn(src.ctypes.data, out.ctypes.data, n_px)
    return out


# ------------------------------------------------------------------------- #
# JPEG decode finish binding (dequant+IDCT plane, YCbCr->RGB)
# ------------------------------------------------------------------------- #

_JPEG_DEC_TABLES: tuple | None = None


def _jpeg_decode_tables() -> tuple:
    """The libjpeg range-limit / color tables, passed to C so there is one
    table definition (codecs/jpeg/libjpeg_exact.py builds them)."""
    global _JPEG_DEC_TABLES
    if _JPEG_DEC_TABLES is None:
        from ..codecs.jpeg import libjpeg_exact as le

        _JPEG_DEC_TABLES = (
            np.ascontiguousarray(le._POST_IDCT, dtype=np.uint8),
            np.ascontiguousarray(le._CC_CLAMP, dtype=np.uint8),
            np.ascontiguousarray(le._CR_R, dtype=np.int32),
            np.ascontiguousarray(le._CB_B, dtype=np.int32),
            np.ascontiguousarray(le._CR_G, dtype=np.int32),
            np.ascontiguousarray(le._CB_G, dtype=np.int32),
        )
    return _JPEG_DEC_TABLES


def jpeg_idct_plane_native(
    blocks: np.ndarray, qtab: np.ndarray, by: int, bx: int
) -> np.ndarray | None:
    """Dequantize + islow-IDCT a component's (by*bx, 64) natural-order
    coefficient blocks straight into a (by*8, bx*8) uint8 plane.
    Bit-identical to the numpy tier (same int64 ops, same tables); None
    when the native tier is unavailable."""
    lib = get_native_lib()
    if lib is None:
        return None
    b = np.ascontiguousarray(blocks, dtype=np.int32)
    q = np.ascontiguousarray(qtab, dtype=np.int32)
    post = _jpeg_decode_tables()[0]
    plane = np.empty((by * 8, bx * 8), dtype=np.uint8)
    lib.jpeg_idct_plane(
        b.ctypes.data, q.ctypes.data, by, bx, post.ctypes.data,
        plane.ctypes.data,
    )
    return plane


def _row_strided_u8(a: np.ndarray) -> np.ndarray:
    """Accept uint8 arrays that are only ROW-strided (cropped views —
    contiguous within each row); anything else gets one copy."""
    if a.dtype == np.uint8 and a.ndim == 2 and a.strides[1] == 1:
        return a
    return np.ascontiguousarray(a, dtype=np.uint8)


def jpeg_ycc_rgb_native(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray
) -> np.ndarray | None:
    """Fixed-point YCbCr->RGB over full-resolution uint8 planes (cropped
    row-strided views convert copy-free); returns (h, w, 3) uint8 or None
    when the native tier is unavailable."""
    lib = get_native_lib()
    if lib is None:
        return None
    yv = _row_strided_u8(y)
    cbv = _row_strided_u8(cb)
    crv = _row_strided_u8(cr)
    _, clamp, cr_r, cb_b, cr_g, cb_g = _jpeg_decode_tables()
    h, w = yv.shape
    out = np.empty((h, w, 3), dtype=np.uint8)
    lib.jpeg_ycc_rgb(
        yv.ctypes.data, cbv.ctypes.data, crv.ctypes.data, h, w,
        yv.strides[0], cbv.strides[0], crv.strides[0],
        cr_r.ctypes.data, cb_b.ctypes.data, cr_g.ctypes.data,
        cb_g.ctypes.data, clamp.ctypes.data, out.ctypes.data,
    )
    return out


def jpeg_fancy_upsample_native(
    plane: np.ndarray, h_expand: int, v_expand: int
) -> np.ndarray | None:
    """Triangular-filter chroma upsample (jdsample.c h2v1/h2v2 fancy),
    bit-identical to the numpy tier; None when unavailable or the ratio
    has no fancy filter (caller falls back to replication/numpy)."""
    lib = get_native_lib()
    if lib is None:
        return None
    if (h_expand, v_expand) == (2, 1):
        fn = lib.jpeg_h2v1_upsample
        oshape = (plane.shape[0], plane.shape[1] * 2)
    elif (h_expand, v_expand) == (2, 2):
        fn = lib.jpeg_h2v2_upsample
        oshape = (plane.shape[0] * 2, plane.shape[1] * 2)
    else:
        return None
    p = _row_strided_u8(plane)
    out = np.empty(oshape, dtype=np.uint8)
    fn(p.ctypes.data, p.shape[0], p.shape[1], p.strides[0], out.ctypes.data)
    return out


# ------------------------------------------------------------------------- #
# PNG defilter binding
# ------------------------------------------------------------------------- #


def defilter_band_native(
    filter_types: np.ndarray,
    rows: np.ndarray,
    previous_row: np.ndarray | None,
    bpp: int,
    in_place: bool = False,
) -> np.ndarray | None:
    """Native counterpart of ops.png_filter.unfilter_band; returns None when
    the native tier is unavailable (caller falls back to numpy).

    ``in_place=True`` defilters directly in ``rows`` (caller must own the
    writable buffer) — the streaming decoder's hot path."""
    lib = get_native_lib()
    if lib is None:
        return None
    if in_place and rows.flags["C_CONTIGUOUS"] and rows.flags["WRITEABLE"] and rows.dtype == np.uint8:
        out = rows
    else:
        out = np.ascontiguousarray(rows, dtype=np.uint8).copy()
    ftypes = np.ascontiguousarray(filter_types, dtype=np.uint8)
    prev = (
        None
        if previous_row is None
        else np.ascontiguousarray(previous_row, dtype=np.uint8)
    )
    rc = lib.png_defilter_band(
        out.ctypes.data_as(ctypes.c_void_p),
        ftypes.ctypes.data_as(ctypes.c_void_p),
        out.shape[0],
        out.shape[1],
        bpp,
        prev.ctypes.data_as(ctypes.c_void_p) if prev is not None else None,
    )
    if rc != 0:
        from ..errors import StitchError

        raise StitchError(f"Unknown filter type in band (native rc={rc})")
    return out


# ------------------------------------------------------------------------- #
# JPEG entropy coding binding
# ------------------------------------------------------------------------- #


def make_huff_table(dc_codes: dict, ac_codes: dict) -> HuffTableC:
    t = HuffTableC()
    for sym, (code, length) in dc_codes.items():
        t.dc_code[sym] = code
        t.dc_len[sym] = length
    for sym, (code, length) in ac_codes.items():
        t.ac_code[sym] = code
        t.ac_len[sym] = length
    return t


def composite_native(dest: np.ndarray, src: np.ndarray) -> bool:
    """Alpha-over ``src`` onto ``dest`` in place; both contiguous (..., 4)
    arrays of the same uint8/uint16 dtype. Returns False when the native
    tier is unavailable (caller falls back to the numpy float64 oracle)."""
    lib = get_native_lib()
    if lib is None:
        return False
    if not (dest.flags["C_CONTIGUOUS"] and src.flags["C_CONTIGUOUS"]):
        return False
    n = dest.size // 4
    if dest.dtype == np.uint16:
        lib.composite_rgba16(
            dest.ctypes.data_as(ctypes.c_void_p),
            src.ctypes.data_as(ctypes.c_void_p), n,
        )
    else:
        lib.composite_rgba8(
            dest.ctypes.data_as(ctypes.c_void_p),
            src.ctypes.data_as(ctypes.c_void_p), n,
        )
    return True


def make_huff_dec_table(min_code, max_code, val_ptr, vals) -> HuffDecTableC:
    t = HuffDecTableC()
    for i in range(17):
        t.min_code[i] = min_code[i]
        t.max_code[i] = max_code[i]
        t.val_ptr[i] = val_ptr[i]
    for i, v in enumerate(bytes(vals)[:256]):
        t.vals[i] = v
    return t


def jpeg_decode_scan_native(
    scan_data: bytes,
    comp_hv: list,  # [(h, v, bx, wb, hb)] per scan component
    dc_tables: list,  # HuffDecTableC slots (4)
    ac_tables: list,
    dc_sel: list,
    ac_sel: list,
    mcux: int,
    mcuy: int,
    restart_interval: int,
    blocks: list,  # per-comp (by*bx, 64) int32 arrays (zeroed, C-contig)
) -> bool:
    """Native baseline-JPEG scan decode; False if the native tier is absent."""
    lib = get_native_lib()
    if lib is None or len(comp_hv) > 3:
        return False
    n = len(comp_hv)
    ch = (ctypes.c_int * n)(*[c[0] for c in comp_hv])
    cv = (ctypes.c_int * n)(*[c[1] for c in comp_hv])
    cbx = (ctypes.c_int * n)(*[c[2] for c in comp_hv])
    cwb = (ctypes.c_int * n)(*[c[3] for c in comp_hv])
    chb = (ctypes.c_int * n)(*[c[4] for c in comp_hv])
    dsel = (ctypes.c_int * n)(*dc_sel)
    asel = (ctypes.c_int * n)(*ac_sel)
    dct = (HuffDecTableC * 4)(*dc_tables)
    act = (HuffDecTableC * 4)(*ac_tables)
    ptrs = [b.ctypes.data_as(ctypes.c_void_p) for b in blocks] + [None] * (3 - n)
    rc = lib.jpeg_decode_scan(
        scan_data, len(scan_data), n, ch, cv, cbx, cwb, chb,
        dct, act, dsel, asel, mcux, mcuy, restart_interval,
        ptrs[0], ptrs[1], ptrs[2],
    )
    if rc != 0:
        from ..errors import StitchError

        raise StitchError(f"JPEG scan decode failed (native rc={rc})")
    return True


def jpeg_decode_progressive_scan_native(
    data: bytes,
    scan_start: int,
    comp_geo: list,  # [(h, v, bx, wb, hb)] per scan component
    dc_tables: list,  # HuffDecTableC slots (4)
    ac_tables: list,
    dc_sel: list,
    ac_sel: list,
    mcux: int,
    mcuy: int,
    restart_interval: int,
    interleaved: bool,
    ss: int,
    se: int,
    ah: int,
    al: int,
    blocks: list,  # per-scan-comp (by*bx, 64) int32 arrays (C-contig)
) -> bool:
    """Native progressive-JPEG scan decode (one scan, coefficients
    accumulated in place); False if the native tier is absent."""
    lib = get_native_lib()
    if lib is None or len(comp_geo) > 4:
        return False
    n = len(comp_geo)
    ch = (ctypes.c_int * n)(*[c[0] for c in comp_geo])
    cv = (ctypes.c_int * n)(*[c[1] for c in comp_geo])
    cbx = (ctypes.c_int * n)(*[c[2] for c in comp_geo])
    cwb = (ctypes.c_int * n)(*[c[3] for c in comp_geo])
    chb = (ctypes.c_int * n)(*[c[4] for c in comp_geo])
    dsel = (ctypes.c_int * n)(*dc_sel)
    asel = (ctypes.c_int * n)(*ac_sel)
    dct = (HuffDecTableC * 4)(*dc_tables)
    act = (HuffDecTableC * 4)(*ac_tables)
    ptrs = [b.ctypes.data_as(ctypes.c_void_p) for b in blocks] + [None] * (4 - n)
    rc = lib.jpeg_decode_progressive_scan(
        data, len(data), scan_start, n, ch, cv, cbx, cwb, chb,
        dct, act, dsel, asel, mcux, mcuy, restart_interval,
        1 if interleaved else 0, ss, se, ah, al,
        ptrs[0], ptrs[1], ptrs[2], ptrs[3],
    )
    if rc != 0:
        from ..errors import StitchError

        raise StitchError(f"JPEG progressive scan decode failed (native rc={rc})")
    return True


def defilter_units_native(
    units: np.ndarray, rowbytes: int, bpp: int, previous_row: np.ndarray | None
) -> np.ndarray | None:
    """Defilter directly from (h, 1+rowbytes) scanline units (filter byte +
    filtered bytes) into fresh raw rows — zero intermediate copies."""
    lib = get_native_lib()
    if lib is None:
        return None
    units = np.ascontiguousarray(units, dtype=np.uint8)
    h = units.shape[0]
    prev = (
        None
        if previous_row is None
        else np.ascontiguousarray(previous_row, dtype=np.uint8)
    )
    out = np.empty((h, rowbytes), dtype=np.uint8)
    rc = lib.png_defilter_units(
        units.ctypes.data,
        units.shape[1],
        h,
        rowbytes,
        bpp,
        prev.ctypes.data if prev is not None else None,
        out.ctypes.data,
    )
    if rc != 0:
        from ..errors import StitchError

        raise StitchError(f"Unknown filter type in band (native rc={rc})")
    return out


def filter_select_band_native(
    rows: np.ndarray, previous_row: np.ndarray | None, bpp: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native filter selection; None when the native tier is unavailable."""
    lib = get_native_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    h, n = rows.shape
    prev = (
        None
        if previous_row is None
        else np.ascontiguousarray(previous_row, dtype=np.uint8)
    )
    types = np.empty(h, dtype=np.uint8)
    out = np.empty_like(rows)
    lib.png_filter_select_band(
        rows.ctypes.data_as(ctypes.c_void_p),
        prev.ctypes.data_as(ctypes.c_void_p) if prev is not None else None,
        h, n, bpp,
        types.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return types, out


def jpeg_quant_band_native(
    band_rgba: np.ndarray, luma_q: np.ndarray, chroma_q: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Fused YCbCr+DCT+quantize on the host (C++ tier); None if unavailable.

    band_rgba: (h, w, 4) uint8 with h%8==0, w%8==0. Returns three
    (h/8*w/8, 64) int16 block arrays (strip-major)."""
    lib = get_native_lib()
    if lib is None:
        return None
    band = np.ascontiguousarray(band_rgba, dtype=np.uint8)
    h, w = band.shape[:2]
    n = (h // 8) * (w // 8)
    lq = np.ascontiguousarray(luma_q, dtype=np.int32)
    cq = np.ascontiguousarray(chroma_q, dtype=np.int32)
    yo = np.empty((n, 64), dtype=np.int16)
    cbo = np.empty((n, 64), dtype=np.int16)
    cro = np.empty((n, 64), dtype=np.int16)
    lib.jpeg_quant_band_444(
        band.ctypes.data_as(ctypes.c_void_p), h, w,
        lq.ctypes.data_as(ctypes.c_void_p), cq.ctypes.data_as(ctypes.c_void_p),
        yo.ctypes.data_as(ctypes.c_void_p),
        cbo.ctypes.data_as(ctypes.c_void_p),
        cro.ctypes.data_as(ctypes.c_void_p),
    )
    return yo, cbo, cro


def jpeg_quant_band_420_native(
    band_rgba: np.ndarray, luma_q: np.ndarray, chroma_q: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Fused YCbCr+2x2 subsample+DCT+quantize (C++ tier); None if
    unavailable. band_rgba: (h, w, 4) uint8 with h%16==0, w%16==0. Returns
    (y (4n, 64) in MCU order [TL,TR,BL,BR], cb (n, 64), cr (n, 64)) —
    bit-identical to ops/jpeg_dct.band_to_blocks_islow_420."""
    lib = get_native_lib()
    if lib is None:
        return None
    band = np.ascontiguousarray(band_rgba, dtype=np.uint8)
    h, w = band.shape[:2]
    if h % 16 or w % 16:
        return None
    n = (h // 16) * (w // 16)
    lq = np.ascontiguousarray(luma_q, dtype=np.int32)
    cq = np.ascontiguousarray(chroma_q, dtype=np.int32)
    yo = np.empty((4 * n, 64), dtype=np.int16)
    cbo = np.empty((n, 64), dtype=np.int16)
    cro = np.empty((n, 64), dtype=np.int16)
    lib.jpeg_quant_band_420(
        band.ctypes.data_as(ctypes.c_void_p), h, w,
        lq.ctypes.data_as(ctypes.c_void_p), cq.ctypes.data_as(ctypes.c_void_p),
        yo.ctypes.data_as(ctypes.c_void_p),
        cbo.ctypes.data_as(ctypes.c_void_p),
        cro.ctypes.data_as(ctypes.c_void_p),
    )
    return yo, cbo, cro


class NativeEntropyCoder:
    """Streaming JPEG entropy coder over the native library."""

    def __init__(self, luma_table: HuffTableC, chroma_table: HuffTableC,
                 sampling: str = "444"):
        self._luma = luma_table
        self._chroma = chroma_table
        self._state = EntropyStateC()
        self._fn_name = (
            "jpeg_entropy_encode_444" if sampling == "444" else "jpeg_entropy_encode_420"
        )
        # Persistent worst-case output scratch, grown geometrically: a fresh
        # np.empty per call costs ~400KB of allocation churn per MCU row.
        self._out: np.ndarray | None = None

    def encode(self, yb: np.ndarray, cbb: np.ndarray, crb: np.ndarray) -> bytes:
        lib = get_native_lib()
        assert lib is not None
        n_mcus = cbb.shape[0]
        yb = np.ascontiguousarray(yb, dtype=np.int16)
        cbb = np.ascontiguousarray(cbb, dtype=np.int16)
        crb = np.ascontiguousarray(crb, dtype=np.int16)
        # Structural worst case is ~528 bytes/block (see kMaxBlockBytes in
        # stitchnative.cpp); the C++ writer also bounds-checks per MCU and
        # returns -1 on exhaustion, so arbitrary int16 input cannot overflow.
        blocks_total = yb.shape[0] + 2 * n_mcus
        cap = int(blocks_total * 528 + 1024)
        if self._out is None or self._out.size < cap:
            self._out = np.empty(max(cap, 1 << 20), dtype=np.uint8)
        out = self._out
        cap = out.size
        n = getattr(lib, self._fn_name)(
            yb.ctypes.data_as(ctypes.c_void_p),
            cbb.ctypes.data_as(ctypes.c_void_p),
            crb.ctypes.data_as(ctypes.c_void_p),
            n_mcus,
            ctypes.byref(self._luma),
            ctypes.byref(self._chroma),
            ctypes.byref(self._state),
            out.ctypes.data_as(ctypes.c_void_p),
            cap,
        )
        if n < 0:
            from ..errors import StitchError

            raise StitchError("JPEG entropy output buffer capacity exhausted")
        return out[:n].tobytes()

    def encode_rgba_band(
        self, band: np.ndarray, luma_q: np.ndarray, chroma_q: np.ndarray
    ) -> bytes | None:
        """Fused convert+FDCT+quantize+entropy over an (h, w, 4) uint8 band
        (h%mcu == w%mcu == 0 for the coder's sampling): one DRAM pass,
        strip-local blocks. Byte-identical to the split quantize -> encode
        path. None when the fused tier is unavailable (caller falls back)."""
        lib = get_native_lib()
        if lib is None:
            return None
        is_420 = self._fn_name == "jpeg_entropy_encode_420"
        mcu = 16 if is_420 else 8
        band = np.ascontiguousarray(band, dtype=np.uint8)
        h, w = band.shape[:2]
        if h % mcu or w % mcu:
            return None
        lq = np.ascontiguousarray(luma_q, dtype=np.int32)
        cq = np.ascontiguousarray(chroma_q, dtype=np.int32)
        blocks_total = 3 * (h // 8) * (w // 8) if not is_420 else (
            6 * (h // 16) * (w // 16))
        cap = int(blocks_total * 528 + 1024)
        if self._out is None or self._out.size < cap:
            self._out = np.empty(max(cap, 1 << 20), dtype=np.uint8)
        out = self._out
        fused = (lib.jpeg_quant_entropy_band_420 if is_420
                 else lib.jpeg_quant_entropy_band_444)
        n = fused(
            band.ctypes.data_as(ctypes.c_void_p), h, w,
            lq.ctypes.data_as(ctypes.c_void_p),
            cq.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(self._luma),
            ctypes.byref(self._chroma),
            ctypes.byref(self._state),
            out.ctypes.data_as(ctypes.c_void_p),
            out.size,
        )
        if n < 0:
            from ..errors import StitchError

            raise StitchError("JPEG entropy output buffer capacity exhausted")
        return out[:n].tobytes()

    def flush(self) -> bytes:
        lib = get_native_lib()
        assert lib is not None
        # Deferred flushing buffers up to 57 bits: 7 bytes + stuffing + the
        # padded final byte -> at most 16 output bytes.
        out = np.empty(24, dtype=np.uint8)
        n = lib.jpeg_entropy_flush(
            ctypes.byref(self._state), out.ctypes.data_as(ctypes.c_void_p)
        )
        return out[:n].tobytes()

    def reset(self) -> None:
        """Zero the bit buffer and DC predictors — the state reset at a
        restart marker (T.81 E.2.4)."""
        self._state = EntropyStateC()


# ------------------------------------------------------------------------- #
# Owned streaming inflate binding
# ------------------------------------------------------------------------- #


class BufferPool:
    """Size-keyed free list of uint8 numpy buffers.

    Decoding many small images churns ~450KB of state/scratch per stream;
    glibc raises its mmap threshold after a few cycles and the churn then
    fragments the heap (RSS grows without live objects). Reusing a bounded
    pool keeps the allocations stable."""

    def __init__(self, per_size: int = 8):
        import threading

        self._per_size = per_size
        self._free: dict[int, list[np.ndarray]] = {}
        # host_threads decode workers share this pool; the check-then-pop
        # sequence needs the lock (uncontended acquire is ~100ns, noise
        # against a band decode). It must be RE-ENTRANT: allocations
        # inside the locked region (setdefault/append) can trigger GC,
        # and NativeInflater.__del__ calls put() on this same pool — a
        # plain Lock self-deadlocks the thread (hit by the round-4 PNG
        # soak, single-threaded). Re-entry is benign: the inner put may
        # append to the same free list mid-append, overshooting
        # per_size by at most one entry.
        self._lock = threading.RLock()

    def get(self, size: int) -> np.ndarray:
        with self._lock:
            lst = self._free.get(size)
            if lst:
                return lst.pop()
        return np.empty(size, dtype=np.uint8)

    def put(self, buf) -> None:
        if buf is None:
            return
        with self._lock:
            lst = self._free.setdefault(buf.size, [])
            if len(lst) < self._per_size:
                lst.append(buf)


buffer_pool = BufferPool()


class NativeInflater:
    """Streaming zlib-stream inflater over the owned C++ decoder
    (stitchnative.cpp owned_inflate): push compressed fragments, pull
    decompressed bytes, O(32KB window + pending input) state.

    Same surface as io.inflate.StreamingInflator. ``strict=True`` verifies
    the stream's Adler-32 trailer against a zlib.adler32 accumulation over
    the produced bytes (C speed, a few % of decode cost) — the strict tier
    keeps the owned decoder instead of falling back to zlib."""

    _COMPACT_AT = 1 << 22  # drop consumed input beyond 4 MB

    def __init__(self, strict: bool = False):
        lib = get_native_lib()
        assert lib is not None
        self._lib = lib
        self._strict = strict
        self._adler = 1 if strict else None
        # Pooled state buffer; owned_inflate_init zeroes the control prefix
        # and the decode tables are built before any lookup, so a recycled
        # buffer needs no pre-zeroing.
        self._st = buffer_pool.get(int(lib.owned_inflate_state_size()))
        self._stp = self._st.ctypes.data_as(ctypes.c_void_p)
        lib.owned_inflate_init(self._stp)
        self._input = bytearray()
        self.finished = False
        self.unused_data = b""

    def __del__(self):
        try:
            st, self._st, self._stp = self._st, None, None
            buffer_pool.put(st)
        except Exception:
            pass

    def push(self, chunk) -> bytes:
        if self.finished:
            if len(chunk):
                from ..errors import StitchError

                raise StitchError(
                    "Inflate stream already finished but more data was pushed"
                )
            return b""
        self._input += bytes(chunk)
        return self._drain()

    def _drain(self) -> bytes:
        lib = self._lib
        parts = []
        if len(self._input):
            view = np.frombuffer(self._input, dtype=np.uint8)
            in_ptr = view.ctypes.data_as(ctypes.c_void_p)
        else:
            view, in_ptr = None, None
        while True:
            cap = 1 << 18
            buf = np.empty(cap, dtype=np.uint8)
            n = lib.owned_inflate(
                in_ptr, len(self._input), self._stp,
                buf.ctypes.data_as(ctypes.c_void_p), cap,
            )
            if n < 0:
                from ..errors import StitchError

                raise StitchError(f"Invalid zlib stream (owned inflate rc={n})")
            if n:
                parts.append(buf[:n].tobytes())
                if self._adler is not None:
                    self._adler = int(lib.stitch_adler32(
                        buf.ctypes.data, len(parts[-1]),
                        self._adler & 0xFFFFFFFF))
            if lib.owned_inflate_state(self._stp) == 5:
                self.finished = True
                self._check_adler()
                in_pos = int(lib.owned_inflate_in_pos(self._stp))
                # Bytes buffered in the bit reader but never consumed count
                # as residual too (they sit just before in_pos).
                bitcount = int(np.frombuffer(self._st[8:12].tobytes(), "<i4")[0])
                start = in_pos - bitcount // 8
                self.unused_data = bytes(self._input[start:])
                if self.unused_data.strip(b"\x00"):
                    from ..errors import StitchError

                    raise StitchError(
                        f"Unexpected {len(self.unused_data)} residual bytes "
                        f"after zlib stream end"
                    )
                break
            if n < cap:
                break  # input-limited
        in_pos = int(lib.owned_inflate_in_pos(self._stp))
        if in_pos > self._COMPACT_AT:
            # Release the buffer exports (the ctypes pointer keeps a
            # reference to the array) before resizing the bytearray.
            view = None
            in_ptr = None
            del self._input[:in_pos]
            lib.owned_inflate_rebase(self._stp)
        return b"".join(parts)

    def finish(self) -> bytes:
        out = self._drain() if not self.finished else b""
        if not self.finished:
            from ..errors import StitchError

            raise StitchError("Truncated or invalid zlib stream")
        return out

    # -- zero-copy variant (the PNG band decoder's hot path) -------------- #

    def feed(self, chunk) -> None:
        """Accrete compressed input without decoding yet."""
        if self.finished:
            if len(chunk):
                from ..errors import StitchError

                raise StitchError(
                    "Inflate stream already finished but more data was pushed"
                )
            return
        # bytearray += accepts any buffer: no intermediate bytes() copy
        # (IDAT spans arrive as memoryviews; the old form copied the whole
        # compressed stream twice — ~2% of the grid headline).
        self._input += chunk

    def drain_into(self, out: np.ndarray) -> int:
        """Decode directly into ``out`` (uint8, C-contiguous); returns bytes
        written. Call repeatedly until it returns 0 (input-limited or done);
        output-limited calls resume exactly where they stopped."""
        if self.finished or not len(out):
            return 0
        lib = self._lib
        # argtypes declare c_void_p, so raw address ints work — cheaper
        # than data_as (which constructs a ctypes pointer per call; this
        # runs a few thousand times per second on many-small-image loads).
        if len(self._input):
            view = np.frombuffer(self._input, dtype=np.uint8)
            in_ptr = view.ctypes.data
        else:
            view, in_ptr = None, None
        n = lib.owned_inflate(
            in_ptr, len(self._input), self._stp,
            out.ctypes.data, len(out),
        )
        if n < 0:
            from ..errors import StitchError

            raise StitchError(f"Invalid zlib stream (owned inflate rc={n})")
        if self._adler is not None and n:
            # AVX2 adler (stitch_adler32, ~2.6x glibc-zlib): strict mode
            # rides the band drain, so this is on the decode hot path.
            self._adler = int(lib.stitch_adler32(
                out.ctypes.data, int(n), self._adler & 0xFFFFFFFF))
        if lib.owned_inflate_state(self._stp) == 5:
            self.finished = True
            self._check_adler()
            in_pos = int(lib.owned_inflate_in_pos(self._stp))
            bitcount = int(np.frombuffer(self._st[8:12].tobytes(), "<i4")[0])
            start = in_pos - bitcount // 8
            self.unused_data = bytes(self._input[start:])
            if self.unused_data.strip(b"\x00"):
                from ..errors import StitchError

                raise StitchError(
                    f"Unexpected {len(self.unused_data)} residual bytes "
                    f"after zlib stream end"
                )
            return int(n)
        in_pos = int(lib.owned_inflate_in_pos(self._stp))
        if in_pos > self._COMPACT_AT:
            view = None
            in_ptr = None
            del self._input[:in_pos]
            lib.owned_inflate_rebase(self._stp)
        return int(n)

    def _check_adler(self) -> None:
        """Strict mode: compare the accumulated Adler-32 of the produced
        bytes against the stream's trailer (parsed by the C decoder)."""
        if self._adler is None:
            return
        stored = int(self._lib.owned_inflate_stream_adler(self._stp))
        if (self._adler & 0xFFFFFFFF) != stored:
            from ..errors import StitchError

            raise StitchError(
                f"Adler-32 mismatch: stream says {stored:#010x}, "
                f"data is {self._adler & 0xFFFFFFFF:#010x}"
            )

    def verify_finished(self) -> None:
        if not self.finished:
            from ..errors import StitchError

            raise StitchError("Truncated or invalid zlib stream")


def native_inflater_available() -> bool:
    return get_native_lib() is not None


# ------------------------------------------------------------------------- #
# Owned streaming deflate binding
# ------------------------------------------------------------------------- #


class NativeDeflator:
    """Streaming zlib-stream compressor over the owned C++ encoder
    (stitchnative.cpp owned_deflate_batch): push raw bytes, batches are
    compressed at sync-flush/finish boundaries with the previous 32KB
    window passed contiguously, so matches reach across batches exactly
    like a stateful zlib stream.

    Same wire contract as zlib: 2-byte header, deflate blocks with
    Z_SYNC_FLUSH empty stored blocks between batches, final block +
    big-endian Adler-32 trailer (computed via zlib.adler32 on the Python
    side at C speed)."""

    def __init__(self, level: int = 6, pool=None, filtered: bool = False):
        lib = get_native_lib()
        assert lib is not None
        self._lib = lib
        # Bit 4 selects the C side's filtered-scanline profile (PNG writer
        # content; see owned_deflate_batch) — level 4-6 only, no-op above.
        self._level = level | (0x10 if filtered and level <= 6 else 0)
        # Pending input is kept as a chunk list and assembled ONCE into a
        # pooled contiguous buffer at submit time: the old bytearray
        # accretion + bytes() snapshot + hist-concat cost three extra
        # full-stream copies per run (~7% of the png_out config).
        self._chunks: list[bytes] = []
        self._pending = 0
        self._window = b""
        self._adler = 1
        self._header_sent = False
        self._finished = False
        # Parallel tier (host_threads): batches are INDEPENDENT compressions
        # — batch k's matcher history is the raw 32KB tail of batch k-1,
        # known at submit time — so a worker pool compresses them
        # concurrently (pigz-style) and the framed outputs concatenate in
        # submit order, byte-identical to the serial stream.
        self._pool = pool
        self._jobs: list = []  # ordered (future | bytes) per batch
        self._max_inflight = 0
        if pool is not None:
            lib.owned_deflate_warmup()  # build lazy tables single-threaded
            self._max_inflight = getattr(pool, "_max_workers", 2) + 2

    @staticmethod
    def _compress_batch(lib, level: int, buf: np.ndarray, hist_len: int,
                        total: int, is_final: bool, first: bool,
                        adler: int) -> bytes:
        """``buf`` is a pooled contiguous [hist | data | 8 zero slack]
        buffer built by _submit; it is returned to the pool here (the
        worker is its last user in the parallel tier)."""
        scratch = buffer_pool.get(int(lib.owned_deflate_scratch_size()))
        try:
            data_len = total - hist_len
            # Worst case is the stored fallback: 5 bytes per 64KB part + the
            # sync/final framing; dynamic blocks are only chosen when smaller.
            cap = data_len + data_len // 32 + 4096
            out = buffer_pool.get(cap)
            n = lib.owned_deflate_batch(
                buf.ctypes.data, hist_len, total,
                1 if is_final else 0, level,
                out.ctypes.data, cap,
                scratch.ctypes.data,
            )
            if n < 0:
                from ..errors import StitchError

                raise StitchError("owned deflate output capacity exhausted")
            parts = []
            if first:
                # CMF/FLG: 32K window deflate, check bits for no preset dict.
                parts.append(b"\x78\x9c")
            parts.append(out[: int(n)].tobytes())
            buffer_pool.put(out)
            if is_final:
                parts.append(adler.to_bytes(4, "big"))
            return b"".join(parts)
        finally:
            buffer_pool.put(scratch)
            buffer_pool.put(buf)

    def compress(self, data) -> bytes:
        """Accrete input; output is produced at flush boundaries (the PNG
        writer always batches, so mid-batch emission is unnecessary)."""
        if self._finished:
            raise RuntimeError("Deflator already finished")
        b = data if isinstance(data, bytes) else bytes(data)
        if b:
            self._chunks.append(b)
            self._pending += len(b)
        return b""

    def _submit(self, is_final: bool) -> None:
        hist = self._window
        hl = len(hist)
        total = hl + self._pending
        # Contract: 8 readable ZERO bytes beyond total (hash loads peek;
        # zeros keep chunk-end match decisions deterministic and identical
        # to the old zero-padded concat).
        buf = buffer_pool.get(total + 8)
        if hl:
            buf[:hl] = np.frombuffer(hist, dtype=np.uint8)
        pos = hl
        for c in self._chunks:
            lc = len(c)
            buf[pos : pos + lc] = np.frombuffer(c, dtype=np.uint8)
            pos += lc
        buf[pos : pos + 8] = 0
        self._chunks.clear()
        self._pending = 0
        # AVX2 adler kernel (~2.6x zlib) — this runs over every raw byte
        # the PNG writer compresses.
        self._adler = int(self._lib.stitch_adler32(
            buf.ctypes.data + hl, total - hl, self._adler & 0xFFFFFFFF))
        self._window = buf[max(0, total - 32768) : total].tobytes()
        first = not self._header_sent
        self._header_sent = True
        if is_final:
            self._finished = True
        args = (self._lib, self._level, buf, hl, total, is_final, first,
                self._adler)
        if self._pool is None:
            self._jobs.append(self._compress_batch(*args))
        else:
            if len(self._jobs) >= self._max_inflight:
                # Backpressure: bound in-flight batches (raw + output bytes)
                # by waiting on the oldest before queueing more.
                oldest = self._jobs[0]
                if hasattr(oldest, "result"):
                    oldest.result()
            self._jobs.append(self._pool.submit(self._compress_batch, *args))

    def _drain(self, block: bool) -> list[bytes]:
        parts = []
        while self._jobs:
            job = self._jobs[0]
            if hasattr(job, "result"):
                if not block and not job.done():
                    break
                job = job.result()
            parts.append(job)
            self._jobs.pop(0)
        return parts

    def flush_sync_parts(self) -> list[bytes]:
        """Z_SYNC_FLUSH analog: compress the pending batch and return every
        COMPLETED batch in order (one list element per batch — the caller
        frames each as its own chunk so parallel output is byte-identical
        to serial), byte-aligned, keeping the stream open. With a pool,
        late batches may still be compressing — they are returned by a
        later flush/finish (order always preserved)."""
        if self._finished:
            return []
        self._submit(is_final=False)
        return self._drain(block=self._pool is None)

    def finish_parts(self) -> list[bytes]:
        if self._finished:
            return self._drain(block=True)
        self._submit(is_final=True)
        return self._drain(block=True)

    def flush_sync(self) -> bytes:
        return b"".join(self.flush_sync_parts())

    def finish(self) -> bytes:
        return b"".join(self.finish_parts())


def native_deflater_available() -> bool:
    return get_native_lib() is not None
