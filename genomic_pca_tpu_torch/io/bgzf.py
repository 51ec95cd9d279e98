"""Block-parallel BGZF codec for the host ingest path.

BGZF — the gzip variant used by `.vcf.gz` (and htslib `.bed.gz`) files —
is a sequence of independent gzip members, each <= 64 KiB uncompressed,
whose compressed size is recorded in a "BC" extra subfield.  The
reference decodes it serially through noodles' BGZF layer
(reference src/vcf.rs:72, whose noodles VCF reader wraps a
single-threaded BGZF reader).  Because the blocks are
independent, decompression parallelizes perfectly; this module scans a
window of compressed bytes, inflates all complete blocks across threads
(native/plinkio.cpp: plinkio_bgzf_scan / plinkio_bgzf_inflate), and
serves the plaintext through a standard buffered file object.

Plain (non-BGZF) gzip members lack the BC subfield; `open_maybe_bgzf`
detects that cheaply and the caller falls back to Python's gzip module,
which handles both formats correctly (just serially).

A copy of `genomic_pca_tpu/io/bgzf.py`: the port keeps its own copy so that it
imports nothing of the JAX package; tests/test_torch_copies.py pins
it to the original.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from pathlib import Path
from typing import BinaryIO, Optional, Union

# Max uncompressed payload per block: 64 KiB minus framing, the htslib
# convention (keeps BSIZE-1 within its u16 field after compression).
BGZF_BLOCK_PAYLOAD = 65280

# The canonical 28-byte BGZF EOF marker block (empty payload).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def is_bgzf_header(head: bytes) -> bool:
    """True if `head` (>= 18 bytes) starts a BGZF member (BC subfield)."""
    if len(head) < 18 or head[:4] != b"\x1f\x8b\x08\x04":
        return False
    (xlen,) = struct.unpack_from("<H", head, 10)
    extra = head[12 : 12 + xlen]
    pos = 0
    while pos + 4 <= len(extra):
        si1, si2, slen = extra[pos], extra[pos + 1], struct.unpack_from("<H", extra, pos + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            return True
        pos += 4 + slen
    return False


def is_bgzf_file(path: Union[str, Path]) -> bool:
    with open(path, "rb") as fh:
        return is_bgzf_header(fh.read(128))


class _BgzfRaw(io.RawIOBase):
    """Raw stream that pumps windows of BGZF blocks through the native
    parallel inflater.  Wrap in io.BufferedReader for readline/iteration."""

    def __init__(self, path: Union[str, Path], n_threads: int = 0,
                 window_bytes: int = 32 << 20):
        self._fh = open(path, "rb")
        self._path = str(path)
        self._n_threads = n_threads
        self._window = window_bytes
        self._carry = b""
        self._buf = b""
        self._pos = 0
        self._eof = False

    def readable(self) -> bool:  # pragma: no cover - io protocol
        return True

    def _pump(self) -> None:
        """Refill self._buf with the next window of decompressed bytes."""
        from genomic_pca_tpu_torch.io.native import bgzf_inflate_native, bgzf_scan_native

        while not self._eof:
            data = self._fh.read(self._window)
            if not data:
                self._eof = True
                if self._carry:
                    raise ValueError(
                        f"truncated BGZF stream in {self._path}: "
                        f"{len(self._carry)} trailing bytes"
                    )
                return
            buf = self._carry + data
            scanned = bgzf_scan_native(buf)
            assert scanned is not None  # caller checked get_lib()
            offsets, csizes, usizes, consumed = scanned
            self._carry = buf[consumed:]
            if len(offsets) == 0:
                if len(self._carry) > (64 << 10):
                    raise ValueError(f"malformed BGZF block in {self._path}")
                continue  # block split across windows; read more
            out = bgzf_inflate_native(buf, offsets, csizes, usizes, self._n_threads)
            assert out is not None
            if out:
                self._buf = out
                self._pos = 0
                return
            # window of empty blocks (EOF markers); keep pumping

    def readinto(self, b) -> int:
        if self._pos >= len(self._buf):
            self._buf = b""
            self._pos = 0
            self._pump()
            if not self._buf:
                return 0
        n = min(len(b), len(self._buf) - self._pos)
        b[:n] = self._buf[self._pos : self._pos + n]
        self._pos += n
        return n

    def close(self) -> None:
        try:
            self._fh.close()
        finally:
            super().close()


def open_maybe_bgzf(path: Union[str, Path],
                    n_threads: int = 0) -> Optional[BinaryIO]:
    """Parallel-decompressing reader for a BGZF file, or None.

    None means the file is not BGZF (plain gzip) or the native library is
    unavailable — the caller should fall back to gzip.open.
    """
    from genomic_pca_tpu_torch.io.native import get_lib

    if get_lib() is None or not is_bgzf_file(path):
        return None
    return io.BufferedReader(_BgzfRaw(path, n_threads=n_threads), 1 << 20)


class BgzfWriter:
    """Minimal BGZF writer (for fixtures and BGZF-framed outputs)."""

    def __init__(self, fh: BinaryIO, level: int = 6):
        self._fh = fh
        self._level = level
        self._pending = bytearray()

    def write(self, data: bytes) -> None:
        self._pending += data
        while len(self._pending) >= BGZF_BLOCK_PAYLOAD:
            self._flush_block(bytes(self._pending[:BGZF_BLOCK_PAYLOAD]))
            del self._pending[:BGZF_BLOCK_PAYLOAD]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        bsize = len(cdata) + 25  # 18 header + cdata + 8 trailer, minus 1
        header = (
            b"\x1f\x8b\x08\x04" + b"\x00" * 4 + b"\x00\xff"
            + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize)
        )
        trailer = struct.pack("<II", zlib.crc32(payload), len(payload))
        self._fh.write(header + cdata + trailer)

    def close(self) -> None:
        if self._pending:
            self._flush_block(bytes(self._pending))
            self._pending.clear()
        self._fh.write(BGZF_EOF)

    def __enter__(self) -> "BgzfWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_bgzf(path: Union[str, Path], data: bytes, level: int = 6) -> None:
    with open(path, "wb") as fh, BgzfWriter(fh, level=level) as bw:
        bw.write(data)


def bgzf_decompress_parallel(data: bytes, n_threads: int = 0) -> Optional[bytes]:
    """One-shot parallel decompress of an in-memory BGZF byte string.

    Returns None when the native library is unavailable; raises
    ValueError on malformed framing or corrupt blocks.
    """
    from genomic_pca_tpu_torch.io.native import bgzf_inflate_native, bgzf_scan_native

    scanned = bgzf_scan_native(data)
    if scanned is None:
        return None
    offsets, csizes, usizes, consumed = scanned
    if consumed != len(data):
        raise ValueError(
            f"truncated BGZF stream: {len(data) - consumed} trailing bytes"
        )
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    return bgzf_inflate_native(data, offsets, csizes, usizes, n_threads)
