"""PNG parser/writer unit tests (model: reference tests/unit/png-parser.test.ts,
png-writer.test.ts)."""

import numpy as np
import pytest

from image_stitch_tpu.codecs.png.parser import (
    iter_chunks,
    parse_png_chunks,
    parse_png_header,
    read_chunk,
)
from image_stitch_tpu.codecs.png.writer import (
    build_png,
    create_chunk,
    create_ihdr,
    create_iend,
    serialize_chunk,
)
from image_stitch_tpu.errors import StitchError
from image_stitch_tpu.types import PngHeader
from image_stitch_tpu.utils import PNG_SIGNATURE, png_crc32


def make_png(width=4, height=3, bit_depth=8, color_type=6):
    header = PngHeader(width=width, height=height, bit_depth=bit_depth, color_type=color_type)
    import zlib

    bpp = 4 if color_type == 6 else 3
    raw = b"".join(b"\x00" + bytes(width * bpp) for _ in range(height))
    return build_png(header, zlib.compress(raw))


def test_roundtrip_header():
    data = make_png(17, 9, 8, 6)
    header = parse_png_header(data)
    assert header.width == 17
    assert header.height == 9
    assert header.bit_depth == 8
    assert header.color_type == 6


def test_chunk_walk_sees_ihdr_idat_iend():
    chunks = parse_png_chunks(make_png())
    assert [c.type for c in chunks] == ["IHDR", "IDAT", "IEND"]


def test_crc_is_verified():
    data = bytearray(make_png())
    # Corrupt one byte of IDAT payload.
    idx = data.index(b"IDAT") + 4
    data[idx] ^= 0xFF
    with pytest.raises(StitchError, match="CRC mismatch"):
        parse_png_chunks(bytes(data))


def test_invalid_signature_rejected():
    with pytest.raises(StitchError, match="signature"):
        parse_png_header(b"NOTAPNG!" + make_png()[8:])


def test_truncated_chunk_rejected():
    data = make_png()
    with pytest.raises(StitchError, match="[Tt]runcated"):
        parse_png_chunks(data[:-6])


def test_created_chunk_crc_matches_spec():
    chunk = create_chunk("IDAT", b"hello")
    assert chunk.crc == png_crc32(b"IDAThello")
    ser = serialize_chunk(chunk)
    parsed, _ = read_chunk(PNG_SIGNATURE + ser, 8)
    assert parsed.type == "IDAT"
    assert parsed.data == b"hello"


def test_ihdr_serialization():
    header = PngHeader(width=300, height=200, bit_depth=16, color_type=2)
    chunk = create_ihdr(header)
    assert chunk.length == 13
    assert parse_png_header(PNG_SIGNATURE + serialize_chunk(chunk) +
                            serialize_chunk(create_iend())) == header


def test_invalid_bit_depth_color_type_combo():
    bad = PngHeader(width=1, height=1, bit_depth=2, color_type=6)
    data = PNG_SIGNATURE + serialize_chunk(create_ihdr(bad)) + serialize_chunk(create_iend())
    with pytest.raises(StitchError, match="bit depth"):
        parse_png_header(data)


def test_pil_can_decode_our_png():
    from tests.utils.fixtures import decode_png_pil, png_from_array

    arr = np.arange(4 * 5 * 4, dtype=np.uint8).reshape(5, 4, 4)
    out = decode_png_pil(png_from_array(arr))
    np.testing.assert_array_equal(out, arr)


def test_buffer_decoder_verifies_crc_by_default():
    """Per-source CRC posture matches the reference:
    buffer inputs verify every chunk CRC by default (PngBufferDecoder routes
    through the CRC-checking parsePngChunks — png-parser.ts:57-64,
    png-decoder.ts:359); an explicit verify_crc=False opts out."""
    import numpy as np

    from image_stitch_tpu.codecs.png.decoder import PngDecoder
    from image_stitch_tpu.errors import StitchError
    from tests.utils.fixtures import png_from_array

    rng = np.random.default_rng(7)
    tile = png_from_array(rng.integers(0, 256, (24, 24, 4), dtype=np.uint8))
    # Corrupt only the CRC field of the IDAT chunk: structure stays valid,
    # so a lenient read succeeds while a CRC-checking read must reject.
    idat = tile.index(b"IDAT")
    length = int.from_bytes(tile[idat - 4:idat], "big")
    crc_at = idat + 4 + length
    bad = bytearray(tile)
    bad[crc_at] ^= 0xFF
    bad = bytes(bad)

    with pytest.raises(StitchError, match="CRC"):
        dec = PngDecoder(bad)  # buffer source: strict by default
        for _ in dec.bands(8):
            pass

    dec = PngDecoder(bad, verify_crc=False)  # explicit opt-out: lenient
    rows = sum(b.shape[0] for b in dec.bands(8))
    dec.close()
    assert rows == 24


def test_file_decoder_stays_lenient_by_default(tmp_path):
    """File-path inputs keep the reference's fd-scan posture (CRC skipped
    on the streaming hot path); explicit verify_crc=True still rejects."""
    import numpy as np

    from image_stitch_tpu.codecs.png.decoder import PngDecoder
    from image_stitch_tpu.errors import StitchError
    from tests.utils.fixtures import png_from_array

    rng = np.random.default_rng(8)
    tile = png_from_array(rng.integers(0, 256, (16, 16, 4), dtype=np.uint8))
    idat = tile.index(b"IDAT")
    length = int.from_bytes(tile[idat - 4:idat], "big")
    bad = bytearray(tile)
    bad[idat + 4 + length] ^= 0xFF
    p = tmp_path / "bad_crc.png"
    p.write_bytes(bytes(bad))

    dec = PngDecoder(str(p))
    rows = sum(b.shape[0] for b in dec.bands(8))
    dec.close()
    assert rows == 16

    with pytest.raises(StitchError, match="CRC"):
        dec = PngDecoder(str(p), verify_crc=True)
        for _ in dec.bands(8):
            pass
