"""ctypes bindings for the native host decode library
(genomic_pca_tpu_torch/native/plinkio.cpp).

A copy of `genomic_pca_tpu/io/native.py` that builds and loads the
port's own copy of the library: `make -C genomic_pca_tpu_torch/native`
into `build/native/libplinkio.so` at the repository root (listed in
.gitignore), never the JAX package's `native/libplinkio.so`; it adds
`parse_table_native`, the .bim / .fam parse of io/bed.py.  Builds
lazily with make/g++ on first use; every caller must handle
`get_lib() is None` and fall back to the pure numpy/Python paths
(identical semantics, covered by equivalence tests).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libplinkio.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

# Process-wide thread budget for the native helpers, set from the CLI's
# -t/--threads flag (reference semantics: one knob for all parallel
# operations, main.rs:103-106).  None = auto (all CPUs, capped).
_default_threads: Optional[int] = None


def set_default_threads(n: Optional[int]) -> None:
    global _default_threads
    _default_threads = n if n and n > 0 else None


def _resolve_threads(n_threads: int) -> int:
    if n_threads > 0:
        return n_threads
    if _default_threads is not None:
        return _default_threads
    return min(os.cpu_count() or 1, 16)


# Must match plinkio_abi_version() in genomic_pca_tpu_torch/native/plinkio.cpp.
_ABI_VERSION = 5


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.plinkio_abi_version.argtypes = []
    lib.plinkio_abi_version.restype = ctypes.c_int64
    lib.plinkio_decode_bed.argtypes = [
        ctypes.c_void_p,  # packed
        ctypes.c_void_p,  # snp_offsets (int64*)
        ctypes.c_int64,  # n_rows
        ctypes.c_int64,  # bytes_per_snp
        ctypes.c_int64,  # n_samples
        ctypes.c_int,  # count_a1
        ctypes.c_int,  # n_threads
        ctypes.c_void_p,  # out
    ]
    lib.plinkio_decode_bed.restype = None
    lib.plinkio_parse_vcf_lines.argtypes = [
        ctypes.c_char_p,  # buf
        ctypes.c_int64,  # len
        ctypes.c_int64,  # n_samples
        ctypes.c_int64,  # max_lines
        ctypes.c_int,  # n_threads
        ctypes.c_void_p,  # dosages
        ctypes.c_void_p,  # keep
        ctypes.c_void_p,  # line_starts
    ]
    lib.plinkio_parse_vcf_lines.restype = ctypes.c_int64
    lib.plinkio_bgzf_scan.argtypes = [
        ctypes.c_char_p,  # buf
        ctypes.c_int64,  # len
        ctypes.c_int64,  # max_blocks
        ctypes.c_void_p,  # offsets (int64*)
        ctypes.c_void_p,  # csizes (int64*)
        ctypes.c_void_p,  # usizes (int64*)
    ]
    lib.plinkio_bgzf_scan.restype = ctypes.c_int64
    lib.plinkio_bgzf_inflate.argtypes = [
        ctypes.c_char_p,  # buf
        ctypes.c_void_p,  # offsets
        ctypes.c_void_p,  # csizes
        ctypes.c_void_p,  # usizes
        ctypes.c_void_p,  # out_offsets
        ctypes.c_int64,  # n_blocks
        ctypes.c_int,  # n_threads
        ctypes.c_void_p,  # out
    ]
    lib.plinkio_bgzf_inflate.restype = ctypes.c_int32
    lib.plinkio_packed_qc_counts.argtypes = [
        ctypes.c_void_p,  # packed
        ctypes.c_void_p,  # snp_offsets (int64*)
        ctypes.c_int64,  # n_rows
        ctypes.c_int64,  # n_samples
        ctypes.c_int,  # n_threads
        ctypes.c_void_p,  # out (int32*, n_rows x 4)
    ]
    lib.plinkio_packed_qc_counts.restype = None
    lib.plinkio_synth_pack.argtypes = [
        ctypes.c_void_p,  # a_pop (uint8*, rows x n_pops)
        ctypes.c_void_p,  # b_pop (uint8*, rows x n_pops)
        ctypes.c_void_p,  # pop (uint8*, n_samples)
        ctypes.c_int64,  # rows
        ctypes.c_int64,  # n_samples
        ctypes.c_int64,  # n_pops
        ctypes.c_uint64,  # seed
        ctypes.c_int64,  # row0
        ctypes.c_int,  # n_threads
        ctypes.c_void_p,  # out (uint8*, rows x ceil(n/4))
    ]
    lib.plinkio_synth_pack.restype = None
    lib.plinkio_parse_table.argtypes = [
        ctypes.c_char_p,  # buf
        ctypes.c_int64,  # len
        ctypes.c_int32,  # n_cols
        ctypes.c_void_p,  # kinds (int32*, n_cols)
        ctypes.c_int64,  # max_rows
        ctypes.c_int,  # n_threads
        ctypes.c_void_p,  # outs (void*, 2 n_cols)
        ctypes.c_void_p,  # sizes (int64*, 2 n_cols)
    ]
    lib.plinkio_parse_table.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            # Unconditional: make no-ops when the .so is newer than the
            # source, rebuilds after source changes.
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, f"OUT={_BUILD_DIR}"],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception as e:  # toolchain absent or build failure
            if not os.path.exists(_LIB_PATH):
                log.info("Native plinkio build unavailable (%s); using numpy paths.", e)
                return None
            log.info("Native plinkio rebuild failed (%s); using existing library.", e)
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            try:
                version = int(lib.plinkio_abi_version())
            except AttributeError:
                version = 1  # pre-versioning builds
            if version != _ABI_VERSION:
                # A stale .so with a different signature set would
                # misinterpret arguments and crash the process; fall back
                # to the (semantically identical) numpy paths instead.
                log.warning(
                    "Native plinkio ABI mismatch (library v%d, binding "
                    "v%d) and rebuild unavailable; using numpy paths.",
                    version, _ABI_VERSION,
                )
                _lib = None
                return _lib
            _lib = _configure(lib)
            log.debug("Loaded native plinkio from %s", _LIB_PATH)
        except OSError as e:
            log.info("Could not load native plinkio (%s); using numpy paths.", e)
            _lib = None
        return _lib


def decode_bed_native(
    packed: np.ndarray,
    snp_offsets: np.ndarray,
    bytes_per_snp: int,
    n_samples: int,
    count_a1: bool,
    n_threads: int = 0,
) -> Optional[np.ndarray]:
    """Multithreaded 2-bit decode; None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_rows = len(snp_offsets)
    out = np.empty((n_rows, n_samples), dtype=np.int8)
    offsets = np.ascontiguousarray(snp_offsets, dtype=np.int64)
    n_threads = _resolve_threads(n_threads)
    lib.plinkio_decode_bed(
        packed.ctypes.data,
        offsets.ctypes.data,
        ctypes.c_int64(n_rows),
        ctypes.c_int64(bytes_per_snp),
        ctypes.c_int64(n_samples),
        ctypes.c_int(1 if count_a1 else 0),
        ctypes.c_int(n_threads),
        out.ctypes.data,
    )
    return out


def packed_qc_counts_native(
    packed: np.ndarray,
    snp_offsets: np.ndarray,
    n_samples: int,
    n_threads: int = 0,
) -> Optional[np.ndarray]:
    """Per-SNP genotype counts (n0, n1, n2, n_valid) straight off packed
    2-bit rows; (n_rows, 4) int32, or None if the native lib is
    unavailable.  Identical counts to ops/qc.py:genotype_counts_packed."""
    lib = get_lib()
    if lib is None:
        return None
    n_rows = len(snp_offsets)
    out = np.empty((n_rows, 4), dtype=np.int32)
    offsets = np.ascontiguousarray(snp_offsets, dtype=np.int64)
    n_threads = _resolve_threads(n_threads)
    lib.plinkio_packed_qc_counts(
        packed.ctypes.data,
        offsets.ctypes.data,
        ctypes.c_int64(n_rows),
        ctypes.c_int64(n_samples),
        ctypes.c_int(n_threads),
        out.ctypes.data,
    )
    return out


def parse_vcf_lines_native(
    buf: bytes, n_samples: int, n_threads: int = 0
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Parse VCF data lines; returns (dosages, keep, line_starts, n_lines)
    or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_threads = _resolve_threads(n_threads)
    max_lines = buf.count(b"\n") + 1
    dosages = np.empty((max_lines, n_samples), dtype=np.int8)
    keep = np.zeros(max_lines, dtype=np.uint8)
    line_starts = np.zeros(max_lines, dtype=np.int64)
    n_lines = lib.plinkio_parse_vcf_lines(
        buf,
        ctypes.c_int64(len(buf)),
        ctypes.c_int64(n_samples),
        ctypes.c_int64(max_lines),
        ctypes.c_int(n_threads),
        dosages.ctypes.data,
        keep.ctypes.data,
        line_starts.ctypes.data,
    )
    return dosages, keep, line_starts, int(n_lines)


def bgzf_scan_native(
    buf: bytes,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Scan complete BGZF blocks in `buf`.

    Returns (offsets, csizes, usizes, consumed_bytes) over the complete
    blocks found, or None if the native lib is unavailable.  Raises
    ValueError if the buffer does not start with BGZF framing.
    """
    lib = get_lib()
    if lib is None:
        return None
    # Minimum BGZF block is 28 bytes (the EOF marker).
    max_blocks = len(buf) // 28 + 1
    offsets = np.empty(max_blocks, dtype=np.int64)
    csizes = np.empty(max_blocks, dtype=np.int64)
    usizes = np.empty(max_blocks, dtype=np.int64)
    n = lib.plinkio_bgzf_scan(
        buf,
        ctypes.c_int64(len(buf)),
        ctypes.c_int64(max_blocks),
        offsets.ctypes.data,
        csizes.ctypes.data,
        usizes.ctypes.data,
    )
    if n < 0:
        raise ValueError("buffer does not start with a BGZF block")
    n = int(n)
    consumed = int(offsets[n - 1] + csizes[n - 1]) if n else 0
    return offsets[:n], csizes[:n], usizes[:n], consumed


def bgzf_inflate_native(
    buf: bytes,
    offsets: np.ndarray,
    csizes: np.ndarray,
    usizes: np.ndarray,
    n_threads: int = 0,
) -> Optional[bytes]:
    """Inflate scanned BGZF blocks in parallel; None if lib unavailable.

    Raises ValueError on corrupt block data (bad deflate stream or CRC).
    """
    lib = get_lib()
    if lib is None:
        return None
    n_blocks = len(offsets)
    out_offsets = np.zeros(n_blocks, dtype=np.int64)
    if n_blocks:
        np.cumsum(usizes[:-1], out=out_offsets[1:])
    total = int(out_offsets[-1] + usizes[-1]) if n_blocks else 0
    out = np.empty(total, dtype=np.uint8)
    n_threads = _resolve_threads(n_threads)
    rc = lib.plinkio_bgzf_inflate(
        buf,
        np.ascontiguousarray(offsets, dtype=np.int64).ctypes.data,
        np.ascontiguousarray(csizes, dtype=np.int64).ctypes.data,
        np.ascontiguousarray(usizes, dtype=np.int64).ctypes.data,
        out_offsets.ctypes.data,
        ctypes.c_int64(n_blocks),
        ctypes.c_int(n_threads),
        out.ctypes.data,
    )
    if rc != 0:
        raise ValueError(f"BGZF inflate failed (native error code {rc})")
    return out.tobytes()


def synth_pack_native(
    a_pop: np.ndarray,
    b_pop: np.ndarray,
    pop: np.ndarray,
    seed: int,
    row0: int = 0,
    n_threads: int = 0,
) -> Optional[np.ndarray]:
    """Generate packed PLINK rows for the synthetic biobank model in ONE
    native pass (PRNG + per-population thresholds + 2-bit pack), or None
    if the library is unavailable (callers fall back to numpy with the
    same model but a different RNG stream).

    a_pop/b_pop: (rows, n_pops) uint8 thresholds (256 p^2 and
    256 p(2-p), clamped to 255); pop: (n_samples,) uint8.  Output
    (rows, ceil(n/4)) uint8.  Deterministic per (seed, row0 + row):
    strip boundaries and thread counts cannot change the bytes.
    """
    lib = get_lib()
    if lib is None:
        return None
    a_pop = np.ascontiguousarray(a_pop, dtype=np.uint8)
    b_pop = np.ascontiguousarray(b_pop, dtype=np.uint8)
    pop = np.ascontiguousarray(pop, dtype=np.uint8)
    rows, n_pops = a_pop.shape
    n_samples = len(pop)
    out = np.empty((rows, (n_samples + 3) // 4), dtype=np.uint8)
    lib.plinkio_synth_pack(
        a_pop.ctypes.data,
        b_pop.ctypes.data,
        pop.ctypes.data,
        ctypes.c_int64(rows),
        ctypes.c_int64(n_samples),
        ctypes.c_int64(n_pops),
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        ctypes.c_int64(row0),
        ctypes.c_int(_resolve_threads(n_threads)),
        out.ctypes.data,
    )
    return out


# Column kinds of `parse_table_native` (plinkio_parse_table).
TABLE_SKIP, TABLE_JOIN, TABLE_CODES, TABLE_INT = 0, 1, 2, 3

_TABLE_HANDOVERS = {
    -1: "a non-blank line with too few fields",
    -2: "an integer field that is not '-' and digits within int64",
    -3: "a byte outside ASCII",
    -4: "a control byte",
    -5: "a carriage return that does not end a line",
}


def _split_joined(buf: np.ndarray, size: int, count: int) -> np.ndarray:
    """The `count` values joined by '\\n' in buf[:size], as an object
    array of str."""
    return np.fromiter(buf[:size].tobytes().decode("ascii").split("\n"),
                       dtype=object, count=count)


def parse_table_native(
    data: bytes, kinds: Sequence[int], n_threads: int = 0
) -> Optional[List[np.ndarray]]:
    """The columns of a whitespace-separated PLINK text table in one
    native pass, or None: when the library is unavailable, and when the
    bytes hold what the caller's own line parse must judge (a short line,
    an integer field other than '-' and digits within int64, a byte
    outside ASCII, a control byte, a lone carriage return).

    `kinds[k]` says what becomes of column k; the table must have at
    least len(kinds) fields on every non-blank line.  One array for each
    column that is not TABLE_SKIP, in column order: TABLE_JOIN and
    TABLE_CODES give object arrays of str (TABLE_CODES columns are built
    from their distinct values, `values[codes]`), TABLE_INT int64."""
    lib = get_lib()
    if lib is None:
        return None
    n_cols = len(kinds)
    # A row holds n_cols fields of one byte or more and n_cols - 1
    # separators; the joined values of a column fit in the table's bytes.
    max_rows = len(data) // (2 * n_cols - 1) + 1
    cap = len(data) + 1
    kinds_arr = np.ascontiguousarray(kinds, dtype=np.int32)
    outs = (ctypes.c_void_p * (2 * n_cols))()
    held = []
    for k, kind in enumerate(kinds):
        if kind == TABLE_JOIN:
            bufs = (np.empty(cap, dtype=np.uint8),)
        elif kind == TABLE_CODES:
            bufs = (np.empty(max_rows, dtype=np.int32), np.empty(cap, dtype=np.uint8))
        elif kind == TABLE_INT:
            bufs = (np.empty(max_rows, dtype=np.int64),)
        else:
            bufs = ()
        for j, b in enumerate(bufs):
            outs[2 * k + j] = b.ctypes.data
        held.append(bufs)
    sizes = np.zeros(2 * n_cols, dtype=np.int64)
    n_rows = int(lib.plinkio_parse_table(
        data,
        ctypes.c_int64(len(data)),
        ctypes.c_int32(n_cols),
        kinds_arr.ctypes.data,
        ctypes.c_int64(max_rows),
        ctypes.c_int(_resolve_threads(n_threads)),
        outs,
        sizes.ctypes.data,
    ))
    if n_rows < 0:
        log.debug("Native table parse handed over: %s.",
                  _TABLE_HANDOVERS.get(n_rows, f"status {n_rows}"))
        return None
    columns = []
    for k, (kind, bufs) in enumerate(zip(kinds, held)):
        if kind == TABLE_JOIN:
            columns.append(_split_joined(bufs[0], int(sizes[2 * k]), n_rows))
        elif kind == TABLE_CODES:
            values = _split_joined(bufs[1], int(sizes[2 * k]), int(sizes[2 * k + 1]))
            columns.append(values[bufs[0][:n_rows]])
        elif kind == TABLE_INT:
            columns.append(bufs[0][:n_rows].copy())
    return columns
