"""Genotype container on one device: the passes of the PCA core.

Counterpart of `genomic_pca_tpu/parallel/sharded.py` on a single device.
The class keeps the name `ShardedMatrix` so that multi-GPU support can
extend it; it takes `device` where the JAX class takes `mesh`.  As in the
JAX class, the dtype of `geno` selects the layout:

- packed (uint8): (d_pad, N4) PLINK bytes in ORIGINAL sample order;
  sample bytes beyond the data are 0x55 (all missing -> 0);
- dense (int8): (d_pad, n_pad) dosages, -127 missing, n_pad the sample
  count rounded up to 128 with -127 (`from_arrays`);

with `mean` / `inv_std` (d_pad, 1) f32.  Padded rows carry inv_std = 0.
The kernels (ops/kernels.py) take any D, so this container adds no row
padding of its own; `from_reference_arrays` keeps the reference's.

Two modes, as in the JAX container: "1d" runs the four 1-D kernels of the
layout; "2d", the wide-sample mode, runs every exact pass as the right
product then the left product over both tiled axes (kernels 5 and 6
packed, 13 and 14 dense), and every q8 steering pass through
`q8_power_pass_2d` (kernels 7 and 8, or their int8 branches 7i and 8i).
The modes differ numerically (the 2-D tsq takes W in f32, the 1-D one W
rounded to bf16), so the port switches at the sample count where the JAX
container does.

Several devices: one rank per device in a `torch.distributed` process
group (parallel/mesh.py), the JAX mesh axis "v".  Every rank holds the
same number of rows (a multiple of the q8 tile `tile_d`), a contiguous
range of the global matrix rows: rank r holds global rows [r * d_pad,
(r + 1) * d_pad), `d_pad` being the rows of one rank.  Each pass runs the
rank's kernels over its rows, then one all-reduce merges the (n_pad x L)
or (L x L) result where the JAX container calls `psum`
(genomic_pca_tpu/parallel/sharded.py:1136-1198); the q8 pass folds
`out - ru` before it.  Everything after a merge (`cholqr2_q`, the
tolerance test, `qr`, `eigh`) runs replicated on identical data (an
all-reduce hands every rank the same bits), so every rank takes the same
exit.  Outputs over rows (A B, the loadings)
are gathered on every rank (`rows_to_host`).  `from_local_rows` splits
the rows into per-rank ranges aligned to `tile_d`, so the q8 row tiles
fall where the one-rank container puts them; `from_owned_units` places
each unit (a VCF file, a rank's QC range) inside its owner's rows and
records the layout as row segments (`row_segments`: global matrix row,
PCA row, count), as the JAX container does.  A rank that owns no rows
holds one tile of inert rows and joins every collective with an exact
zero contribution, so every rank launches the same kernels.

The core takes the basis padded to `n_pad` samples (`basis`) and runs
`exact_pass`, `q8_pass` and `ritz_gram` on it, each pass with its
all-reduce; its spans are the core's (models/pca.py).
`COUNTS["passes_2d"]` counts the passes that run in the 2-D mode: each
exact pass, q8 pass, Rayleigh-Ritz Gram and right product (the loadings,
`right_apply`) once; `COUNTS["block_fetch_kernel"]` (counted by
`kernels.standardize_runs`) each `fetch_blocks_device` call that the
card's kernel serves.

Not ported here: the TPU tile choosers.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from genomic_pca_tpu_torch.ops import kernels
from genomic_pca_tpu_torch.ops.rsvd import quantize_basis
from genomic_pca_tpu_torch.ops.standardize import MISSING
from genomic_pca_tpu_torch.parallel import mesh
from genomic_pca_tpu_torch.utils.profiling import count, to_host

PACKED_MISSING_BYTE = 0x55  # four 01 (missing) fields

# Sample counts (padded, n_pad = 4 * N4) from which the container runs in
# the 2-D mode.  They are the points where the JAX package's
# `auto_tile_d` (genomic_pca_tpu/parallel/sharded.py:195-227) finds no
# row tile for its 15.5 MiB VMEM budget and its container switches to
# mode "pallas2d": a fixed 1280 * n_pad bytes (q8, bf16; 1536 * n_pad
# for f32) plus a 32-row tile at 6 * n_pad (10 * n_pad) bytes exceeds
# the budget from n_pad = 11,264 (9,216); n_pad steps by 512 in the
# packed layout.  Same rule, same algorithm for the same data.
WIDE_N_PAD = 11_264
WIDE_N_PAD_F32 = 9_216
# The same rule for the dense int8 layout, whose n_pad steps by 128: the
# budget fails at 1472 * n_pad bytes (q8, bf16: 1280 + 6 * 32) from n_pad
# = 11,136 (11,008 still fits) and at 1856 * n_pad (f32: 1536 + 10 * 32)
# from 8,832 (8,704 fits).
DENSE_WIDE_N_PAD = 11_136
DENSE_WIDE_N_PAD_F32 = 8_832


def default_mode(n_pad: int, kernel_precision: str, packed: bool = True) -> str:
    f32 = kernel_precision == "f32"
    if packed:
        wide = WIDE_N_PAD_F32 if f32 else WIDE_N_PAD
    else:
        wide = DENSE_WIDE_N_PAD_F32 if f32 else DENSE_WIDE_N_PAD
    return "2d" if n_pad >= wide else "1d"


def resolve_q8_polish(
    q8_polish: Optional[int], missing_fraction: Optional[float]
) -> int:
    """Exact-iteration count finishing a quantized power loop: one pass
    up to 2% missingness (or unknown), two above; an explicit value >= 1
    overrides."""
    if q8_polish is not None:
        if q8_polish < 1:
            raise ValueError("q8_polish must be >= 1 (the Rayleigh-Ritz "
                             "basis must come from an exact pass)")
        return int(q8_polish)
    if missing_fraction is not None and missing_fraction > 0.02:
        return 2
    return 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def inv_std_of(s: np.ndarray) -> np.ndarray:
    """1/std with the zero-std convention (0 -> standardize to zero)."""
    s = np.asarray(s)
    return np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0)


def packed_cols(n_samples: int) -> int:
    """Device byte columns of packed rows: ceil(n/4) padded to 128."""
    return _round_up(max(-(-n_samples // 4), 1), 128)


def dense_cols(n_samples: int) -> int:
    """Device columns of dense int8 rows: n padded to 128, as the JAX
    `from_arrays` pads them."""
    return _round_up(n_samples, 128)


def host_moments(g: np.ndarray) -> tuple:
    """(mean, std) f32 of (D, N) int8 dosages from exact integer
    histograms over valid entries (std with ddof 1; 0 below two valid
    entries), as the JAX `from_arrays` computes them when none are
    given."""
    n1 = (g == 1).sum(axis=1, dtype=np.int64)
    n2 = (g == 2).sum(axis=1, dtype=np.int64)
    nv = n1 + n2 + (g == 0).sum(axis=1, dtype=np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        m = np.where(nv > 0, (n1 + 2.0 * n2) / np.maximum(nv, 1), 0.0)
        ssd = (n1 + 4.0 * n2) - nv * m * m
        var = np.where(nv >= 2, ssd / np.maximum(nv - 1, 1), 0.0)
        s = np.sqrt(np.maximum(var, 0.0))
    return m.astype(np.float32), s.astype(np.float32)


def sanitize_partial_byte(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """Force trailing 2-bit fields of the last data byte to 01 (missing).

    PLINK zero-fills trailing bits, and code 00 means dosage 2 - NOT
    inert.  Call on raw BED bytes before device use."""
    rem = n_samples % 4
    if rem == 0 or packed.shape[1] == 0:
        return packed
    packed = packed.copy()
    keep = (1 << (2 * rem)) - 1
    fill = PACKED_MISSING_BYTE & (0xFF ^ keep)
    packed[:, -1] = (packed[:, -1] & keep) | fill
    return packed


def pack_int8_rows(geno: np.ndarray) -> np.ndarray:
    """(D, N) int8 dosages (-127 missing) -> (D, ceil(N/4)) PLINK bytes
    with inert trailing fields."""
    from genomic_pca_tpu_torch.io.bed import pack_bed_rows

    geno = np.asarray(geno)
    return sanitize_partial_byte(pack_bed_rows(geno), geno.shape[1])


def _whole_matrix(constructor: str) -> None:
    """Refuse a constructor that puts every row on this rank's device when
    a process group of several ranks is in use: each rank would hold the
    whole matrix and every merge would count it once a rank."""
    if mesh.process_count() > 1:
        raise ValueError(f"ShardedMatrix.{constructor} holds the whole matrix "
                         "on one device; with several ranks use "
                         "from_local_rows or from_owned_units")


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# The 1-D kernels of each layout (packed?): gram, tsq, right, q8.
_KERNELS_1D = {
    True: (kernels.fused_gram_apply_packed, kernels.fused_tsq_packed,
           kernels.fused_right_apply_packed, kernels.fused_gram_q8_packed),
    False: (kernels.fused_gram_apply, kernels.fused_tsq,
            kernels.fused_right_apply, kernels.fused_gram_q8),
}
# The exact 2-D products of each layout: right (A B), left (A^T W).
_KERNELS_2D = {
    True: (kernels.fused_right_apply_2d_packed, kernels.fused_left_apply_2d_packed),
    False: (kernels.fused_right_apply_2d, kernels.fused_left_apply_2d),
}


class ShardedMatrix:
    """Standardized genotype operator, packed or dense int8, over the
    rows of this rank (all rows on one device without a process group).

    Implements ops.operator.StandardizedOperator: the products and the
    passes of the core in models/pca.py.  `kernel_precision` "q8" (default)
    steers with the int8 kernel and runs every exact pass in bf16; "bf16"
    and "f32" run only exact passes at that precision.  `tile_d` is the
    q8 quantization tile (rows sharing one z scale).  `mode` is "1d",
    "2d" or None (chosen from the layout and the sample count by
    `default_mode`).  `geno`, `mean` and `inv_std` hold this rank's
    `d_pad` rows; `row_segments` (S, 3) rows of (global matrix row, PCA
    row, count) place the real rows when they are not the prefix [0,
    n_rows) of the global rows.
    """

    def __init__(
        self,
        geno: torch.Tensor,
        mean: torch.Tensor,
        inv_std: torch.Tensor,
        n_rows: int,
        n_samples: int,
        device,
        tile_d: int = 1024,
        kernel_precision: str = "q8",
        q8_polish: Optional[int] = None,
        missing_fraction: Optional[float] = None,
        mode: Optional[str] = None,
        row_segments: Optional[np.ndarray] = None,
    ):
        if kernel_precision not in ("q8", "bf16", "f32"):
            raise ValueError(f"unknown kernel_precision {kernel_precision!r}")
        if mode not in (None, "1d", "2d"):
            raise ValueError(f"mode must be None, '1d' or '2d', got {mode!r}")
        self.device = torch.device(device)
        self.geno = geno
        self.mean = mean
        self.inv_std = inv_std
        self.n_rows = n_rows
        self.n_samples = n_samples
        self.tile_d = tile_d
        self.kernel_precision = kernel_precision
        self.exact_precision = "bf16" if kernel_precision == "q8" else kernel_precision
        self.q8_polish = resolve_q8_polish(q8_polish, missing_fraction)
        if geno.dtype not in (torch.uint8, torch.int8):
            raise TypeError(f"geno must be uint8 (packed) or int8 (dense), got {geno.dtype}")
        self.packed = geno.dtype == torch.uint8
        self.d_pad = geno.shape[0]
        self.n_pad = geno.shape[1] * 4 if self.packed else geno.shape[1]
        self.mode = mode or default_mode(self.n_pad, kernel_precision, self.packed)
        self._k1d = _KERNELS_1D[self.packed]
        self._k2d = _KERNELS_2D[self.packed]
        self._u = mean * inv_std
        self.rank = mesh.process_index()
        self.world = mesh.process_count()
        self.row_offset = self.rank * self.d_pad  # global row of local row 0
        if row_segments is not None:
            row_segments = np.asarray(row_segments, dtype=np.int64).reshape(-1, 3)
            if int(row_segments[:, 2].sum()) != n_rows:
                raise ValueError("row_segments must hold n_rows rows")
        self.row_segments = row_segments

    # ------------------------------------------------------------------
    @staticmethod
    def from_reference_arrays(
        geno: np.ndarray,
        mean: np.ndarray,
        inv_std: np.ndarray,
        n_rows: int,
        n_samples: int,
        device,
        **kw,
    ) -> "ShardedMatrix":
        """Adopt already padded arrays verbatim: (d_pad, N4) uint8 packed
        or (d_pad, n_pad) int8 dense genotypes and (d_pad, 1) f32, e.g.
        `np.asarray(sm.geno)` of the JAX container, so that both
        containers hold identical bytes.  With a process group of R
        ranks the arrays are the whole matrix of a container over a mesh
        of a multiple of R devices, and rank r adopts its shard, rows [r
        d_pad / R, (r + 1) d_pad / R); pass the JAX container's
        `row_segments` in `kw` where it has them."""
        dev = torch.device(device)
        world, rank = mesh.process_count(), mesh.process_index()
        geno = np.asarray(geno)
        if geno.shape[0] % world:
            raise ValueError(f"{geno.shape[0]} rows do not split over {world} ranks")
        per = geno.shape[0] // world
        rows = slice(rank * per, (rank + 1) * per)

        def column(x):
            x = np.asarray(x, np.float32).reshape(-1, 1)[rows]
            return torch.tensor(x, device=dev)

        return ShardedMatrix(
            geno=torch.tensor(geno[rows], device=dev),
            mean=column(mean), inv_std=column(inv_std),
            n_rows=n_rows, n_samples=n_samples, device=dev, **kw,
        )

    @staticmethod
    def _rank_block(rows: int, n_samples: int, packed: bool, device):
        """Empty (geno, mean, inv_std) of one rank's `rows` inert rows:
        all-missing genotypes over the padded columns, zero moments."""
        cols = packed_cols(n_samples) if packed else dense_cols(n_samples)
        fill = PACKED_MISSING_BYTE if packed else MISSING
        dtype = torch.uint8 if packed else torch.int8
        return (torch.full((rows, cols), fill, dtype=dtype, device=device),
                torch.zeros((rows, 1), dtype=torch.float32, device=device),
                torch.zeros((rows, 1), dtype=torch.float32, device=device))

    @staticmethod
    def _fill_rows(block, ofs: int, g, m, s, n_samples: int, packed: bool,
                   center_only: bool) -> None:
        """Write rows (geno, mean, std) into `block` from local row `ofs`:
        host genotypes (packed bytes sanitized here), or a device tensor
        already in the container's layout; std 1 with `center_only`."""
        if not isinstance(g, torch.Tensor):
            g = np.asarray(g, dtype=np.uint8 if packed else np.int8)
            if packed:
                g = sanitize_partial_byte(g, n_samples)
            g = torch.from_numpy(g)
        r = g.shape[0]
        s = np.ones(r, np.float32) if center_only else np.asarray(s, np.float32)
        geno, mean, inv = block
        geno[ofs:ofs + r, : g.shape[1]].copy_(g)
        mean[ofs:ofs + r, 0].copy_(torch.from_numpy(np.asarray(m, np.float32)))
        inv[ofs:ofs + r, 0].copy_(torch.from_numpy(inv_std_of(s).astype(np.float32)))

    @staticmethod
    def from_local_rows(
        read_rows: Callable[[int, int], tuple],
        n_rows: int,
        n_samples: int,
        device,
        tile_d: int = 1024,
        packed: bool = False,
        center_only: bool = False,
        **kw,
    ) -> "ShardedMatrix":
        """Each rank reads only its own range of the global rows: the
        JAX `from_local_rows` (genomic_pca_tpu/parallel/sharded.py:572).

        The rows split into R equal ranges of `ceil(n_rows / R)` rounded
        up to `tile_d` (at least one tile), so each range starts on a q8
        tile boundary of the one-rank container; rank r reads rows [r
        per, min((r + 1) per, n_rows)) through `read_rows(lo, hi)`, which
        returns host (geno, mean, std): (hi - lo, N) int8 dosages, or
        with `packed` (hi - lo, ceil(N / 4)) raw PLINK bytes (sanitized
        here).  The padding rows are inert."""
        world, rank = mesh.process_count(), mesh.process_index()
        per = _round_up(max(-(-n_rows // world), 1), tile_d)
        lo, hi = rank * per, min((rank + 1) * per, n_rows)
        dev = torch.device(device)
        block = ShardedMatrix._rank_block(per, n_samples, packed, dev)
        if lo < hi:
            g, m, s = read_rows(lo, hi)
            ShardedMatrix._fill_rows(block, 0, g, m, s, n_samples, packed,
                                     center_only)
        return ShardedMatrix(*block, n_rows=n_rows, n_samples=n_samples,
                             device=dev, tile_d=tile_d, **kw)

    @staticmethod
    def from_owned_units(
        unit_counts,
        unit_owner,
        local_units,
        n_samples: int,
        device,
        tile_d: int = 1024,
        packed: bool = False,
        center_only: bool = False,
        strip_rows: int = 262_144,
        **kw,
    ) -> "ShardedMatrix":
        """Unit-sharded construction: the JAX `from_owned_units`
        (genomic_pca_tpu/parallel/sharded.py:667-809), one device per
        rank.

        `unit_counts` / `unit_owner` (U,) are known to every rank: each
        unit's rows and the rank that owns it; global PCA row order is
        unit order.  `local_units` {unit: (geno, mean, std)} holds this
        rank's units (with `packed`, raw PLINK bytes); `geno` is the host
        rows or a reader `read(lo, hi)` of the unit's rows [lo, hi) (host
        rows, or device rows in the container's layout),
        which is called strip by strip of `strip_rows` rows so that the
        host never holds the whole unit, as in `from_packed_strips`.
        Each unit becomes one row segment placed consecutively inside its
        owner's rows, so no genotype leaves the rank that read it; every
        rank holds the largest rank's total rounded up to `tile_d` (at
        least one tile), and a rank that owns nothing holds inert rows
        only."""
        world, rank = mesh.process_count(), mesh.process_index()
        unit_counts = np.asarray(unit_counts, dtype=np.int64)
        unit_owner = np.asarray(unit_owner, dtype=np.int64)
        if len(unit_owner) and (unit_owner.min() < 0 or unit_owner.max() >= world):
            raise ValueError(f"unit owners must be ranks of 0..{world - 1}")
        totals = np.bincount(unit_owner, weights=unit_counts,
                             minlength=world).astype(np.int64)
        per = _round_up(max(int(totals.max(initial=0)), 1), tile_d)
        pca_ofs = np.concatenate([[0], np.cumsum(unit_counts)])
        cursor = np.zeros(world, dtype=np.int64)
        placement = {}
        segments = []
        for u, cnt in enumerate(unit_counts):
            if cnt == 0:
                continue
            p = int(unit_owner[u])
            placement[u] = p * per + int(cursor[p])
            cursor[p] += cnt
            segments.append((placement[u], int(pca_ofs[u]), int(cnt)))
        dev = torch.device(device)
        block = ShardedMatrix._rank_block(per, n_samples, packed, dev)
        for u, (g, m, s) in local_units.items():
            if int(unit_owner[u]) != rank:
                raise ValueError(f"rank {rank} supplied unit {u} it does not own")
            cnt = int(unit_counts[u])
            if not callable(g):
                g = np.asarray(g)
                if g.shape[0] != cnt:
                    raise ValueError(f"unit {u} has {g.shape[0]} rows, not {cnt}")
            read = g if callable(g) else (lambda lo, hi, g=g: g[lo:hi])
            for lo in range(0, cnt, strip_rows):
                hi = min(lo + strip_rows, cnt)
                rows = read(lo, hi)
                if rows.shape[0] != hi - lo:
                    raise ValueError(f"unit {u}: read({lo}, {hi}) gave "
                                     f"{rows.shape[0]} rows")
                ShardedMatrix._fill_rows(
                    block, placement[u] - rank * per + lo, rows, m[lo:hi],
                    None if s is None else s[lo:hi], n_samples, packed,
                    center_only)
        return ShardedMatrix(*block, n_rows=int(unit_counts.sum()),
                             n_samples=n_samples, device=dev, tile_d=tile_d,
                             row_segments=np.asarray(segments, np.int64).reshape(-1, 3),
                             **kw)

    @staticmethod
    def _moments(mean, std, n_rows: int, device) -> tuple:
        m = np.asarray(mean, dtype=np.float32).reshape(n_rows, 1)
        iv = inv_std_of(np.asarray(std, dtype=np.float32)).astype(np.float32)
        return (torch.as_tensor(m).to(device),
                torch.as_tensor(iv.reshape(n_rows, 1)).to(device))

    @staticmethod
    def from_packed_rows(
        packed_rows: np.ndarray,
        mean: np.ndarray,
        std: np.ndarray,
        n_samples: int,
        device,
        **kw,
    ) -> "ShardedMatrix":
        """Build from raw PLINK bytes (D, ceil(N/4)); trailing fields are
        sanitized and the byte axis pads to `packed_cols` with 0x55."""
        _whole_matrix("from_packed_rows")
        packed_rows = sanitize_partial_byte(
            np.asarray(packed_rows, dtype=np.uint8), n_samples
        )
        d = packed_rows.shape[0]
        g_pad = np.full((d, packed_cols(n_samples)), PACKED_MISSING_BYTE, np.uint8)
        g_pad[:, : packed_rows.shape[1]] = packed_rows
        dev = torch.device(device)
        m, iv = ShardedMatrix._moments(mean, std, d, dev)
        return ShardedMatrix(
            torch.as_tensor(g_pad).to(dev), m, iv, d, n_samples, dev, **kw
        )

    @staticmethod
    def from_packed_strips(
        read_strip: Callable[[int, int], np.ndarray],
        n_rows: int,
        mean: np.ndarray,
        std: np.ndarray,
        n_samples: int,
        device,
        strip_rows: int = 262_144,
        **kw,
    ) -> "ShardedMatrix":
        """Same result as `from_packed_rows`, uploading strip-sized host
        buffers into one preallocated device block, so the host never
        holds the whole padded matrix.  `read_strip(lo, hi)` returns
        SANITIZED packed rows [lo, hi)."""
        _whole_matrix("from_packed_strips")
        dev = torch.device(device)
        n4 = packed_cols(n_samples)
        geno = torch.empty((n_rows, n4), dtype=torch.uint8, device=dev)
        for lo in range(0, n_rows, strip_rows):
            hi = min(lo + strip_rows, n_rows)
            buf = np.full((hi - lo, n4), PACKED_MISSING_BYTE, dtype=np.uint8)
            rows = read_strip(lo, hi)
            buf[:, : rows.shape[1]] = rows
            geno[lo:hi].copy_(torch.from_numpy(buf))
        m, iv = ShardedMatrix._moments(mean, std, n_rows, dev)
        return ShardedMatrix(geno, m, iv, n_rows, n_samples, dev, **kw)

    @staticmethod
    def from_arrays(
        geno_strips,
        means: Optional[List[np.ndarray]] = None,
        stds: Optional[List[np.ndarray]] = None,
        strip_size: int = 2048,
        center_only: bool = False,
        *,
        device,
        **kw,
    ) -> "ShardedMatrix":
        """The dense int8 container from host (rows, N) int8 strips
        (-127 missing), as the JAX `from_arrays`: moments per strip from
        `means` / `stds`, or else from exact host histograms
        (`host_moments`); `center_only` sets std to 1; columns pad to a
        multiple of 128 with -127.  Strips upload one by one into a
        preallocated device block whose padding is filled on the device.
        `strip_size` is accepted for API compatibility."""
        _whole_matrix("from_arrays")
        gs: List[np.ndarray] = []
        ms: List[np.ndarray] = []
        ss: List[np.ndarray] = []
        for i, g in enumerate(geno_strips):
            g = np.asarray(g, dtype=np.int8)
            if means is not None and stds is not None:
                m = np.asarray(means[i], dtype=np.float32)
                s = np.asarray(stds[i], dtype=np.float32)
            else:
                m, s = host_moments(g)
            gs.append(g)
            ms.append(m)
            ss.append(np.ones_like(m) if center_only else s)
        if not gs:
            raise ValueError("No strips provided.")
        n_samples = gs[0].shape[1]
        n_rows = sum(g.shape[0] for g in gs)
        n_pad = dense_cols(n_samples)
        dev = torch.device(device)
        geno = torch.full((n_rows, n_pad), MISSING, dtype=torch.int8, device=dev)
        lo = 0
        for g in gs:
            geno[lo:lo + g.shape[0], :n_samples].copy_(torch.from_numpy(g))
            lo += g.shape[0]
        m, iv = ShardedMatrix._moments(np.concatenate(ms), np.concatenate(ss),
                                       n_rows, dev)
        return ShardedMatrix(geno, m, iv, n_rows, n_samples, dev, **kw)

    # ------------------------------------------------------------------
    def basis(self, b) -> torch.Tensor:
        """An (n_samples, l) basis padded to (n_pad, l) with zero rows:
        the layout every pass below takes."""
        b = _as_tensor(b, self.device)
        out = torch.zeros((self.n_pad, b.shape[1]), dtype=torch.float32,
                          device=self.device)
        out[: b.shape[0]] = b
        return out

    # The passes of each mode: the JAX container's `_local_ops`
    # (genomic_pca_tpu/parallel/sharded.py:948-1061) over this rank's
    # rows, each merged by one all-reduce where the JAX container calls
    # psum (:1136-1156).  In 2-D mode gram is W = A B then A^T W, tsq is
    # W^T W on the f32 W (a plain f32 product, TF32 off, as the
    # reference's jnp.dot at HIGHEST outside any kernel), and the q8 pass
    # is q8_power_pass_2d; both layouts.  Each counts one pass of the 2-D
    # mode (`_count_2d`), the Rayleigh-Ritz Gram's right product inside it.
    def _count_2d(self) -> None:
        if self.mode == "2d":
            count("passes_2d")

    def _gram(self, bp: torch.Tensor) -> torch.Tensor:
        self._count_2d()
        args = (self.geno, self.mean, self.inv_std)
        if self.mode == "2d":
            w = self._k2d[0](*args, bp, self.exact_precision)
            out = self._k2d[1](*args, w, self.exact_precision)
        else:
            out = self._k1d[0](*args, bp, self.exact_precision)
        return mesh.all_reduce_sum(out)

    def _tsq(self, bp: torch.Tensor) -> torch.Tensor:
        self._count_2d()
        args = (self.geno, self.mean, self.inv_std, bp, self.exact_precision)
        if self.mode == "2d":
            w = self._k2d[0](*args)
            return mesh.all_reduce_sum(w.T @ w)
        return mesh.all_reduce_sum(self._k1d[1](*args))

    def _right(self, bp: torch.Tensor) -> torch.Tensor:
        self._count_2d()
        fn = self._k2d[0] if self.mode == "2d" else self._k1d[2]
        return fn(self.geno, self.mean, self.inv_std, bp, self.exact_precision)

    def _gram_q8(self, bp: torch.Tensor) -> torch.Tensor:
        self._count_2d()
        fn = kernels.q8_power_pass_2d if self.mode == "2d" else self._k1d[3]
        bq, sb, csum = quantize_basis(bp)
        out, ru = fn(self.geno, self.inv_std, self._u, bq, sb, csum,
                     tile_d=self.tile_d)
        # The rank-1 term broadcasts over sample rows: fold it before the
        # merge, as the JAX gram_q8_sm does.
        return mesh.all_reduce_sum(out - ru)

    # ---- public passes ------------------------------------------------
    def gram_apply(self, b) -> torch.Tensor:
        """A^T (A B): (n_samples, l)."""
        return self._gram(self.basis(b))[: self.n_samples]

    def tsq_accumulate(self, b) -> torch.Tensor:
        """(A B)^T (A B): (l, l)."""
        return self._tsq(self.basis(b))

    def right_apply(self, b) -> np.ndarray:
        """A B on host with padding removed: (n_rows, l) in PCA row
        order, on every rank."""
        return self.rows_to_host(self._right(self.basis(b)))

    # ---- the passes of the core (models/pca.py), on padded bases --------
    resident = True

    def exact_pass(self, bp: torch.Tensor) -> torch.Tensor:
        return self._gram(bp)

    def q8_pass(self, bp: torch.Tensor) -> torch.Tensor:
        return self._gram_q8(bp)

    def ritz_gram(self, q: torch.Tensor):
        """(A Q)^T (A Q), and `right(v, w)`: this rank's rows A V."""
        return self._tsq(q), lambda v, w: self._right(v)

    def rows_to_host(self, local: torch.Tensor) -> np.ndarray:
        """This rank's (d_pad, k) rows -> (n_rows, k) in PCA row order on
        the host of every rank: a tiled all-gather in rank order."""
        return self._trim_rows(to_host(mesh.all_gather_rows(local)).numpy())

    def _strip_rows(self) -> int:
        """Rows per strip of the torch-side scans: 64 Mi elements."""
        return max(1, (1 << 26) // self.n_pad)

    def _standardized(self, rows) -> torch.Tensor:
        """(R, n_pad) f32 standardized rows (a slice or an index tensor)
        in original sample order, missing -> 0, in f32 as the reference's
        XLA slicers and strip scans compute them."""
        return kernels.standardize(self.geno[rows], self.mean[rows],
                                   self.inv_std[rows], "f32")

    def left_apply(self, w) -> np.ndarray:
        """A^T W: (n_samples, k) for row-space W (n_rows, k), in original
        sample order: the device projection path (with A over new
        samples and the training moments, `left_apply(loadings)` is
        PCA::transform).  The reference computes it as an XLA strip scan
        outside any kernel (genomic_pca_tpu/parallel/sharded.py:1162-1198,
        1561-1596); here each strip of this rank's real rows is
        standardized in f32 and multiplied by torch.matmul, and the ranks'
        sums are all-reduced.  Padded rows are inert (never read)."""
        w = np.asarray(w, dtype=np.float32)
        if w.ndim != 2 or w.shape[0] != self.n_rows:
            raise ValueError(f"left_apply expects ({self.n_rows}, k), got {w.shape}")
        w_t = torch.as_tensor(w, device=self.device)
        out = torch.zeros((self.n_pad, w.shape[1]), dtype=torch.float32,
                          device=self.device)
        step = self._strip_rows()
        for l0, p0, cnt in self._local_runs():
            for off in range(0, cnt, step):
                c = min(step, cnt - off)
                out += (self._standardized(slice(l0 + off, l0 + off + c)).T
                        @ w_t[p0 + off:p0 + off + c])
        return to_host(mesh.all_reduce_sum(out)[: self.n_samples]).numpy()

    # ---- row layout: segments and ranks ---------------------------------
    @property
    def _segments_or_default(self) -> np.ndarray:
        """(S, 3) rows of (global matrix row, PCA row, count)."""
        if self.row_segments is None:
            return np.array([[0, 0, self.n_rows]], dtype=np.int64)
        return self.row_segments

    def _local_runs(self) -> List[tuple]:
        """(local row, PCA row, count) of each run of real rows on this
        rank, in global row order."""
        lo, hi = self.row_offset, self.row_offset + self.d_pad
        out = []
        for m0, p0, cnt in self._segments_or_default:
            a, b = max(int(m0), lo), min(int(m0 + cnt), hi)
            if a < b:
                out.append((a - lo, int(p0) + a - int(m0), b - a))
        return out

    def translate_row_runs(self, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """PCA row run starts -> global matrix row starts under the
        segmented layout (the JAX container's, :1396-1422).  Raises
        ValueError if a run crosses a segment boundary; zero-length runs
        (batch padding) translate to row 0."""
        starts = np.asarray(starts, dtype=np.int64)
        if self.row_segments is None:
            return starts
        seg = self.row_segments
        lens = np.asarray(lens, dtype=np.int64)
        si = np.clip(np.searchsorted(seg[:, 1], starts, side="right") - 1,
                     0, len(seg) - 1)
        inside = ((starts >= seg[si, 1]) & (starts + lens <= seg[si, 1] + seg[si, 2])
                  | (lens == 0))
        if not bool(inside.all()):
            raise ValueError("block run crosses a row-segment boundary; use the "
                             "host accessor path for this block file")
        return np.where(lens == 0, 0, seg[si, 0] + (starts - seg[si, 1]))

    def rank_of_runs(self, runs: np.ndarray) -> np.ndarray:
        """The rank holding each (start, len) PCA row run (0 for a
        zero-length run); raises ValueError for a run that crosses a
        segment or a rank boundary."""
        runs = np.asarray(runs, dtype=np.int64).reshape(-1, 2)
        m = self.translate_row_runs(runs[:, 0], runs[:, 1])
        per = max(self.d_pad, 1)
        last = m + np.maximum(runs[:, 1], 1) - 1
        if not bool((m // per == last // per).all()):
            raise ValueError("block run crosses a rank boundary; use the host "
                             "accessor path for this block file")
        return np.where(runs[:, 1] == 0, 0, m // per)

    def runs_device_sliceable(self, runs: np.ndarray) -> bool:
        """True when every (start, len) run lies inside one row segment
        and one rank, so that `fetch_blocks_device` can slice it on the
        rank that holds it."""
        try:
            self.rank_of_runs(runs)
            return True
        except ValueError:
            return False

    def _trim_rows(self, arr: np.ndarray) -> np.ndarray:
        """(world d_pad, ...) host array of the global rows -> (n_rows, ...)
        real rows in PCA row order (drops inter-segment and tail
        padding)."""
        if self.row_segments is None:
            return arr[: self.n_rows]
        out = np.empty((self.n_rows,) + arr.shape[1:], dtype=arr.dtype)
        for m0, p0, cnt in self.row_segments:
            out[p0:p0 + cnt] = arr[m0:m0 + cnt]
        return out

    # ---- device-resident block access ---------------------------------
    def fetch_blocks_device(
        self,
        starts: np.ndarray,
        lens: np.ndarray,
        bucket: int,
        col_idx: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, bucket, C) f32 standardized row runs sliced from this
        rank's rows, in original sample order: row i of block b is PCA
        row starts[b] + i for i < lens[b], and 0 beyond; missing
        genotypes are 0; C = n_pad, or len(col_idx).  Every run of
        nonzero length must lie on this rank (`rank_of_runs`).

        The reference's `fetch_blocks_device` with `_slice_blocks_impl`
        (dense) and `_slice_blocks_packed_impl` (packed)
        (genomic_pca_tpu/parallel/sharded.py:305-376, 1447-1479), with one
        difference of layout: where a bucket would pass the last row the
        reference reads a window moved back to end there, so the run sits
        lower in its bucket; here every run starts at row 0 of its
        bucket, so a block's local basis rows are its SNPs in order.  The
        batch is one `kernels.standardize_runs` call (on the card its
        kernel, which counts itself in `COUNTS["block_fetch_kernel"]`)."""
        bucket = min(bucket, self.d_pad)
        lens = np.asarray(lens, dtype=np.int64)
        owner = self.rank_of_runs(np.stack([np.asarray(starts), lens], axis=1))
        if bool(((owner != self.rank) & (lens > 0)).any()):
            raise ValueError(f"fetch_blocks_device: a run is not on rank {self.rank}")
        local = self.translate_row_runs(starts, lens) - self.row_offset
        x = kernels.standardize_runs(self.geno, self.mean, self.inv_std, local, lens,
                                     bucket)
        return x if col_idx is None else x[:, :, col_idx]

    def count_missing(self) -> int:
        """Missing genotypes among real rows and samples (for the strict
        `missing_policy="error"`), counted in int64 and summed over the
        ranks."""
        valid = torch.arange(self.n_pad, device=self.device) < self.n_samples
        miss = 0
        step = self._strip_rows()
        for l0, _p0, cnt in self._local_runs():
            for lo in range(l0, l0 + cnt, step):
                g = self.geno[lo:min(lo + step, l0 + cnt)]
                hit = kernels.packed_codes(g) == 1 if self.packed else g == MISSING
                miss += int((hit & valid).sum(dtype=torch.int64))
        total = torch.tensor([miss], dtype=torch.int64, device=self.device)
        return int(to_host(mesh.all_reduce_sum(total)).item())
