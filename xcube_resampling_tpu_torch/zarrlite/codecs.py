"""Chunk codecs for zarrlite: a dependency-free blosc1 decoder.

Virtually every production zarr v2 store (including the reference's own
example data, reference tests/gridmapping/test_dataset.py:83-106) uses the
numcodecs ``Blosc`` compressor.  This module decodes the c-blosc 1.x frame
format without the C library:

* 16-byte header (version, lz-version, flags, typesize, nbytes, blocksize,
  cbytes), per-block offset table, per-block streams with int32 length
  prefixes (``csize == stream size`` marks a stored/uncompressed stream).
* Inner codecs: **lz4 / lz4hc** (pure-Python LZ4 block decoder below),
  **zstd** (via the ``zstandard`` wheel), **zlib** (stdlib).  ``blosclz``
  and ``snappy`` raise with a clear message.
* Byte-shuffle is undone with a numpy transpose; bit-shuffle is not
  supported (numcodecs default is byte-shuffle).

Writes keep using zlib/raw (zarrlite never needs to produce blosc frames).
Pure-Python lz4 decode runs at a few MB/s — fine for opening reference
datasets; speed-critical pipelines should store zlib/raw or zstd.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# (flags >> 5) & 7 -> inner codec id (c-blosc blosc.h)
_BLOSCLZ, _LZ4, _SNAPPY, _ZLIB, _ZSTD = 0, 1, 2, 3, 4

_MEMCPYED = 0x2
_BITSHUFFLE = 0x4
_BYTESHUFFLE = 0x1


def lz4_block_decompress(src: bytes, out_size: int) -> bytearray:
    """Decode one raw LZ4 *block* (not the frame format) of known
    decompressed size.  Pure Python, byte-exact with the reference
    implementation's sequence semantics (literals run + match copy with
    possibly overlapping windows)."""
    dst = bytearray(out_size)
    s = 0
    d = 0
    n = len(src)
    while s < n:
        token = src[s]
        s += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[s]
                s += 1
                lit += b
                if b != 255:
                    break
        if lit:
            dst[d : d + lit] = src[s : s + lit]
            s += lit
            d += lit
        if s >= n:
            break  # last sequence has no match
        # match
        offset = src[s] | (src[s + 1] << 8)
        s += 2
        if offset == 0:
            raise ValueError("lz4: zero match offset")
        mlen = (token & 0xF) + 4
        if mlen == 19:
            while True:
                b = src[s]
                s += 1
                mlen += b
                if b != 255:
                    break
        ref = d - offset
        if ref < 0:
            raise ValueError("lz4: match offset before output start")
        if offset >= mlen:
            dst[d : d + mlen] = dst[ref : ref + mlen]
            d += mlen
        else:
            # overlapping copy: repeat the window byte-by-byte pattern
            chunk = bytes(dst[ref:d])
            reps = -(-mlen // offset)
            seq = (chunk * reps)[:mlen]
            dst[d : d + mlen] = seq
            d += mlen
    if d != out_size:
        raise ValueError(f"lz4: decoded {d} bytes, expected {out_size}")
    return dst


def _decode_stream(codec: int, payload: bytes, out_size: int) -> bytes:
    if codec == _LZ4:
        return bytes(lz4_block_decompress(payload, out_size))
    if codec == _ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=out_size
        )
    if codec == _ZLIB:
        return zlib.decompress(payload)
    if codec == _BLOSCLZ:
        raise ValueError(
            "blosc chunk uses the blosclz inner codec, which zarrlite does "
            "not decode; re-write the store with cname lz4/zstd/zlib"
        )
    if codec == _SNAPPY:
        raise ValueError("blosc/snappy chunks are not supported")
    raise ValueError(f"unknown blosc inner codec id {codec}")


def _unshuffle(data: bytes, typesize: int) -> bytes:
    """Undo blosc byte-shuffle: data holds all byte-0s, then all byte-1s,
    ... of the elements."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size // typesize
    tail = arr[n * typesize :]
    body = arr[: n * typesize].reshape(typesize, n).T.reshape(-1)
    return body.tobytes() + tail.tobytes()


def _decode_block(
    raw: bytes, start: int, end: int, codec: int, neblock: int, typesize: int,
    split_ok: bool,
) -> bytes:
    """Decode one blosc block (possibly split into *typesize* streams).

    The split decision is a compressor-side heuristic that changed across
    c-blosc versions; rather than replicating every variant, try the
    recorded-unsplit layout first and fall back to the split layout (and
    vice versa), validating stream bookkeeping exactly."""

    def attempt(nstreams: int) -> bytes:
        pos = start
        parts = []
        per = neblock // nstreams
        for i in range(nstreams):
            size = per if i < nstreams - 1 else neblock - per * (nstreams - 1)
            (csize,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            if csize < 0 or pos + csize > end:
                raise ValueError("blosc: stream overruns block")
            payload = raw[pos : pos + csize]
            pos += csize
            if csize == size:
                parts.append(payload)  # stored uncompressed
            else:
                part = _decode_stream(codec, payload, size)
                if len(part) != size:
                    raise ValueError("blosc: stream size mismatch")
                parts.append(part)
        return b"".join(parts)

    candidates = [1]
    if split_ok and typesize > 1 and neblock % typesize == 0:
        candidates = [typesize, 1]
    last_err: Exception | None = None
    for nstreams in candidates:
        try:
            return attempt(nstreams)
        except (ValueError, struct.error) as e:
            last_err = e
    raise ValueError(f"blosc: cannot decode block: {last_err}")


def blosc_decompress(raw: bytes) -> bytes:
    """Decode one c-blosc 1.x frame into its uncompressed bytes."""
    if len(raw) < 16:
        raise ValueError("blosc: frame shorter than header")
    flags = raw[2]
    typesize = raw[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", raw, 4)
    if cbytes > len(raw):
        raise ValueError("blosc: truncated frame")
    if flags & _MEMCPYED:
        return raw[16 : 16 + nbytes]
    if flags & _BITSHUFFLE:
        raise ValueError(
            "blosc bit-shuffle is not supported (byte-shuffle and no-shuffle"
            " are); re-write the store with shuffle=SHUFFLE"
        )
    if nbytes == 0:
        return b""
    codec = (flags >> 5) & 0x7
    nblocks = -(-nbytes // blocksize)
    bstarts = struct.unpack_from(f"<{nblocks}i", raw, 16)
    out = []
    for i in range(nblocks):
        neblock = min(blocksize, nbytes - i * blocksize)
        end = bstarts[i + 1] if i + 1 < nblocks else cbytes
        # offsets are not guaranteed monotone in every writer; bound each
        # block by the frame end instead when they are not
        if end <= bstarts[i]:
            end = cbytes
        block = _decode_block(
            raw, bstarts[i], end, codec, neblock, typesize,
            split_ok=neblock == blocksize,
        )
        if flags & _BYTESHUFFLE and typesize > 1:
            block = _unshuffle(block, typesize)
        out.append(block)
    return b"".join(out)
