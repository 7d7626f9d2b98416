"""Streaming deflate with Z_SYNC_FLUSH batching.

Counterpart of ``StreamingDeflator`` (reference: src/streaming-deflate.ts:41-242):
level-6 deflate, batched writes, periodic ``Z_SYNC_FLUSH`` so compressed bytes
emerge incrementally with bounded memory, and a final ``Z_FINISH``. Runs on
the host; its 1 MB cadence mirrors the reference's IDAT batching
(image-concat-core.ts:336-338).
"""

from __future__ import annotations

import zlib
from typing import Callable, Iterable, Iterator

DEFAULT_LEVEL = 6  # reference: streaming-deflate.ts:55, image-concat-core.ts:342
DEFAULT_MAX_BATCH = 1 * 1024 * 1024  # reference: image-concat-core.ts:336


class StreamingDeflator:
    """Push raw bytes, receive compressed chunks through ``on_data``.

    Two tiers: the owned C++ deflate (stitchnative.cpp owned_deflate_batch —
    hash-chain lazy matcher, per-block dynamic Huffman, ~1.8x CPython zlib
    at a slightly better ratio on filtered-PNG data) handles the default
    and filtered strategies at levels 1-9; zlib remains the tier for rle/
    huffman, level 0, and STITCH_TPU_NO_NATIVE fallback. ``content_hint=
    "filtered_png"`` (the PNG writer sets it) selects the native
    filtered-scanline matcher profile under the default strategy — the
    writer's input is always filter residuals, where the shallow-chain
    profile measured +20% stage speed at zlib-6-parity size while costing
    real ratio on text-like content (sweep_deflate_profile.py, round 4).
    Output framing is identical either way: zlib header, Z_SYNC_FLUSH
    batches, final block + Adler-32."""

    def __init__(
        self,
        level: int = DEFAULT_LEVEL,
        max_batch_size: int = DEFAULT_MAX_BATCH,
        on_data: Callable[[bytes], None] | None = None,
        strategy: str = "default",
        pool=None,
        content_hint: str = "generic",
    ) -> None:
        strategies = {
            "default": zlib.Z_DEFAULT_STRATEGY,
            "filtered": zlib.Z_FILTERED,
            "rle": zlib.Z_RLE,
            "huffman": zlib.Z_HUFFMAN_ONLY,
        }
        if strategy not in strategies:
            raise ValueError(f"Unknown deflate strategy: {strategy}")
        self._obj = None
        self._native = None
        if strategy in ("default", "filtered") and 1 <= level <= 9:
            from ..native import native_deflater_available

            if native_deflater_available():
                from ..native import NativeDeflator

                # pool (host_threads): sync-flush batches compress
                # concurrently, byte-identical output (pigz-style — each
                # batch's dictionary is the previous batch's raw tail).
                self._native = NativeDeflator(
                    level, pool=pool,
                    filtered=(strategy == "filtered"
                              or content_hint == "filtered_png"),
                )
        if self._native is None:
            self._obj = zlib.compressobj(
                level, zlib.DEFLATED, zlib.MAX_WBITS, 8, strategies[strategy]
            )
        self._on_data = on_data or (lambda _b: None)
        self._max_batch = max_batch_size
        self._pending = 0
        self._finished = False

    def initialize(self, on_data: Callable[[bytes], None]) -> None:
        """Late callback binding (mirrors reference initialize(),
        streaming-deflate.ts:60-110)."""
        self._on_data = on_data

    def push(self, data: bytes | memoryview) -> None:
        if self._finished:
            raise RuntimeError("Deflator already finished")
        if self._native is not None:
            self._native.compress(data)
        else:
            out = self._obj.compress(bytes(data))
            if out:
                self._on_data(out)
        self._pending += len(data)
        if self._pending >= self._max_batch:
            self.flush()

    def flush(self) -> None:
        """Z_SYNC_FLUSH: emit everything buffered while keeping the deflate
        state (reference: flushInternal, streaming-deflate.ts:223-238)."""
        if self._finished:
            return
        if self._native is not None:
            # One on_data call per compressed batch: under the parallel tier
            # a flush can return several late batches at once, and per-batch
            # framing keeps the emitted chunk boundaries — hence the output
            # bytes — identical to the serial path.
            for out in self._native.flush_sync_parts():
                if out:
                    self._on_data(out)
        else:
            out = self._obj.flush(zlib.Z_SYNC_FLUSH)
            if out:
                self._on_data(out)
        self._pending = 0

    def finish(self) -> None:
        if self._finished:
            return
        if self._native is not None:
            self._finished = True
            for out in self._native.finish_parts():
                if out:
                    self._on_data(out)
        else:
            out = self._obj.flush(zlib.Z_FINISH)
            self._finished = True
            if out:
                self._on_data(out)


def compress_streaming(
    chunks: Iterable[bytes],
    level: int = DEFAULT_LEVEL,
    max_batch_size: int = DEFAULT_MAX_BATCH,
) -> Iterator[bytes]:
    """Generator wrapper (reference: compressStreaming, streaming-deflate.ts:244-267)."""
    produced: list[bytes] = []
    deflator = StreamingDeflator(level, max_batch_size, produced.append)
    for chunk in chunks:
        deflator.push(chunk)
        while produced:
            yield produced.pop(0)
    deflator.finish()
    while produced:
        yield produced.pop(0)
