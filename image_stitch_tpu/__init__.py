"""image_stitch_tpu — an accelerator-backed image compositing and codec framework.

A from-scratch JAX/XLA/Pallas redesign with the capabilities and API surface
of the TypeScript library ``jburnhams/image-stitch`` (reference:
src/index.ts:46-123): stitch PNG/JPEG/HEIC inputs into a PNG or JPEG output
via grid layouts (columns/rows/width/height) or free-form positioned layouts
with z-ordered Porter-Duff alpha blending — streaming, with O(canvas_width)
host memory.

Like the reference root module (src/index.ts:38-43), importing this package
registers the PNG + JPEG + HEIC decoder plugins as defaults.
"""

from __future__ import annotations

# ---- public high-level API (reference: src/image-concat.ts:34-52) ----------
from .api import (
    StreamingConcatenator,
    concat,
    concat_arrays,
    concat_streaming,
    concat_to_buffer,
    concat_to_file,
    concat_to_stream,
)
from .core import CoreStreamingConcatenator

# ---- options / shared types (reference: src/types.ts) -----------------------
from .errors import StitchError
from .types import (
    ColorType,
    ConcatOptions,
    DecoderOptions,
    ImageHeader,
    ImageSource,
    Layout,
    PngChunk,
    PngHeader,
    PositionedImage,
)

# ---- decoder subsystem (reference: src/decoders/index.ts) -------------------
from .codecs.detect import detect_format, detect_image_format, read_magic_bytes, validate_format
from .codecs.factory import (
    LazyImageDecoder,
    create_decoder,
    create_decoders,
    create_decoders_from_iterable,
    extract_positions,
    has_positioned_images,
    validate_positioned_inputs,
)
from .codecs.registry import (
    DecoderPlugin,
    clear_default_decoder_plugins,
    get_default_decoder_plugins,
    set_default_decoder_plugins,
)
from .codecs.png.decoder import (
    PngBlobDecoder,
    PngBufferDecoder,
    PngDecoder,
    PngFileDecoder,
    png_plugin,
)
from .codecs.jpeg.decoder import (
    JpegBufferDecoder,
    JpegDecoder,
    JpegFileDecoder,
    jpeg_plugin,
    parse_jpeg_header,
)
from .codecs.heic import HeicBufferDecoder, HeicDecoder, HeicFileDecoder, heic_plugin
from .codecs.input_cache import (
    disable_input_cache,
    enable_input_cache,
    input_cache_enabled,
)

# ---- low-level PNG APIs (reference: src/index.ts:53-123) --------------------
from .codecs.png.parser import (
    iter_chunks,
    parse_palette,
    parse_png_chunks,
    parse_png_header,
    read_chunk,
)
from .codecs.png.writer import (
    build_png,
    create_chunk,
    create_idat,
    create_iend,
    create_ihdr,
    serialize_chunk,
)
from .codecs.png.adapters import (
    FileInputAdapter,
    PngInputAdapter,
    PngParser,
    Uint8ArrayInputAdapter,
    create_input_adapter,
)
from .codecs.png.batch import (
    compress_data,
    compress_image_data,
    decompress_data,
    decompress_image_data,
    extract_pixel_data,
)
from .ops.adam7 import ADAM7_PASSES, deinterlace_adam7, get_pass_dimensions, has_adam7_passes
from .ops.png_filter import (
    FilterType,
    filter_scanline,
    filter_select_band,
    paeth_predictor,
    unfilter_band,
    unfilter_scanline,
)
from .ops.pixel import (
    composite_band,
    composite_scanline,
    convert_band,
    convert_pixel_format,
    convert_scanline,
    copy_pixel_region,
    create_blank_image,
    determine_common_format,
    extract_scanline_portion,
    fill_pixel_region,
    get_transparent_color,
    parse_background_color,
    scale_sample,
)
from .io.deflate import StreamingDeflator, compress_streaming
from .io.inflate import StreamingInflator

# ---- JPEG encoder (reference: src/jpeg-encoder.ts:96-264) -------------------
from .codecs.jpeg.encoder import JpegEncoder, StreamingJpegEncoder, encode_jpeg

from .utils import (
    PNG_SIGNATURE,
    get_bytes_per_pixel,
    get_samples_per_pixel,
    is_png_signature,
    png_crc32,
    read_u32be,
    write_u32be,
)

# Reference alias (src/index.ts exports pngCrc32 as crc32 too).
crc32 = png_crc32

__version__ = "0.1.0"

# Register default decoder plugins: PNG + JPEG + HEIC
# (reference: src/index.ts:38-43).
set_default_decoder_plugins([png_plugin(), jpeg_plugin(), heic_plugin()])

__all__ = [
    # high-level
    "concat_to_buffer",
    "concat_to_stream",
    "concat_to_file",
    "concat_streaming",
    "concat",
    "concat_arrays",
    "StreamingConcatenator",
    "CoreStreamingConcatenator",
    # types
    "ConcatOptions",
    "Layout",
    "DecoderOptions",
    "ColorType",
    "PngHeader",
    "PngChunk",
    "ImageHeader",
    "PositionedImage",
    "ImageSource",
    "StitchError",
    # decoders
    "DecoderPlugin",
    "set_default_decoder_plugins",
    "get_default_decoder_plugins",
    "clear_default_decoder_plugins",
    "create_decoder",
    "create_decoders",
    "create_decoders_from_iterable",
    "LazyImageDecoder",
    "has_positioned_images",
    "extract_positions",
    "validate_positioned_inputs",
    "detect_format",
    "detect_image_format",
    "read_magic_bytes",
    "validate_format",
    "PngDecoder",
    "PngFileDecoder",
    "PngBufferDecoder",
    "PngBlobDecoder",
    "png_plugin",
    "JpegDecoder",
    "JpegFileDecoder",
    "JpegBufferDecoder",
    "jpeg_plugin",
    "parse_jpeg_header",
    "HeicDecoder",
    "HeicFileDecoder",
    "HeicBufferDecoder",
    "heic_plugin",
    "enable_input_cache",
    "disable_input_cache",
    "input_cache_enabled",
    # low-level PNG
    "PngParser",
    "PngInputAdapter",
    "FileInputAdapter",
    "Uint8ArrayInputAdapter",
    "create_input_adapter",
    "parse_png_header",
    "parse_png_chunks",
    "parse_palette",
    "read_chunk",
    "iter_chunks",
    "create_chunk",
    "serialize_chunk",
    "create_ihdr",
    "create_iend",
    "create_idat",
    "build_png",
    "decompress_data",
    "compress_data",
    "decompress_image_data",
    "compress_image_data",
    "extract_pixel_data",
    "FilterType",
    "filter_scanline",
    "filter_select_band",
    "unfilter_scanline",
    "unfilter_band",
    "paeth_predictor",
    "ADAM7_PASSES",
    "deinterlace_adam7",
    "get_pass_dimensions",
    "has_adam7_passes",
    # pixel ops
    "convert_scanline",
    "convert_band",
    "composite_scanline",
    "composite_band",
    "extract_scanline_portion",
    "determine_common_format",
    "convert_pixel_format",
    "copy_pixel_region",
    "fill_pixel_region",
    "create_blank_image",
    "get_transparent_color",
    "parse_background_color",
    "scale_sample",
    # io
    "StreamingInflator",
    "StreamingDeflator",
    "compress_streaming",
    # jpeg
    "JpegEncoder",
    "StreamingJpegEncoder",
    "encode_jpeg",
    # utils
    "PNG_SIGNATURE",
    "png_crc32",
    "crc32",
    "is_png_signature",
    "read_u32be",
    "write_u32be",
    "get_bytes_per_pixel",
    "get_samples_per_pixel",
]
