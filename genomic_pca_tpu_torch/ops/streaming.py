"""Host-streamed standardized matrix, for genotype matrices larger than
the card's memory.

Counterpart of `genomic_pca_tpu/ops/streaming.py` on one device.  The
genotype strips live on the host (decoded from the BED per pass, or held
in RAM) and every pass streams all of them through the card: the
prefetcher's worker threads make each strip's host payload
(`io/prefetch.py` `StripPrefetcher`), the consumer thread copies it into
one of two pinned staging buffers and uploads it on a side CUDA stream
into one of two device buffers, and the compute stream waits on an event
of that copy before it runs the strip's kernels.  Strip i + 1's copy thus
overlaps strip i's kernels, and the host holds at most PREFETCH_DEPTH
strips ready.

Strips are PLINK 2-bit bytes (`packed=True`, a quarter of the bytes per
pass over the host-device link, which bounds this container) or int8
dosages with -127 missing, both in ORIGINAL sample order.  The mode ("1d"
or "2d") follows the resident container's rule (`default_mode`), and each
strip runs the kernels of its layout and mode:

  mode "1d": gram = fused_gram_apply(_packed), q8 = fused_gram_q8(_packed),
             right = fused_right_apply(_packed);
  mode "2d": gram = fused_right_apply_2d(_packed) then
             fused_left_apply_2d(_packed), q8 = q8_power_pass_2d,
             right = fused_right_apply_2d(_packed);

and tsq is W^T W of the f32 W = right(B) in both modes, as in the
reference.  Partial sums over strips are added on the device.

Several ranks (parallel/mesh.py) stand where the JAX container's
devices do (genomic_pca_tpu/ops/streaming.py:108-117): strip i is read,
uploaded and computed on rank i mod R, each rank from its own source (its
own mmap of the BED), with the prefetch workers of one host divided among
its ranks.  A rank adds its strips' partial sums in strip order and one
`mesh.all_reduce_sum` a pass merges them where the JAX container calls
`_combine` (the q8 pass folds `out - ru` first); a rank with fewer
strips, or none, joins every all-reduce with exact zeros.  Everything
after a merge (`qr`, the tolerance test) runs on identical data on every
rank, so every rank leaves the power loop at the same pass.  Rows out
(`right_apply`, `tsq_and_project`, `_tsq_and_capture`) are gathered
(`mesh.all_gather_rows`) and put back in global row order, the same on
every rank.

`last_telemetry` describes the last pass and `pass_log` every pass of
the container: strips, bytes uploaded, host wall seconds, the
seconds the copies took on the copy stream and their GB/s, and the
seconds the compute stream waited on copies (CUDA events; None on the
CPU), all of this rank's strips; and with several ranks the seconds of
the pass's all-reduce or gather on the host clock.

Not ported: the reference's plane-major sample permutation and VMEM tile
sizing (the kernels here take any row count and original sample order),
and its relayed backend's rule on which thread may upload (uploads here
run on the consumer thread because the staging buffers are its own).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from genomic_pca_tpu_torch.io.prefetch import StripPrefetcher
from genomic_pca_tpu_torch.ops import kernels
from genomic_pca_tpu_torch.ops.rsvd import quantize_basis
from genomic_pca_tpu_torch.ops.standardize import MISSING
from genomic_pca_tpu_torch.parallel import mesh
from genomic_pca_tpu_torch.parallel.sharded import (
    PACKED_MISSING_BYTE, default_mode, dense_cols, inv_std_of, packed_cols,
    resolve_q8_polish,
)

log = logging.getLogger(__name__)

# Strips the prefetcher holds ready ahead of the consumer, and its most
# worker threads on one host (the reference container's defaults).
PREFETCH_DEPTH = 3
PREFETCH_WORKERS = 4

# Kernels of each (packed, mode): (right, left or None, gram 1-D or None, q8).
_STRIP_KERNELS = {
    (True, "1d"): (kernels.fused_right_apply_packed, None,
                   kernels.fused_gram_apply_packed, kernels.fused_gram_q8_packed),
    (False, "1d"): (kernels.fused_right_apply, None, kernels.fused_gram_apply,
                    kernels.fused_gram_q8),
    (True, "2d"): (kernels.fused_right_apply_2d_packed,
                   kernels.fused_left_apply_2d_packed, None,
                   kernels.q8_power_pass_2d),
    (False, "2d"): (kernels.fused_right_apply_2d, kernels.fused_left_apply_2d,
                    None, kernels.q8_power_pass_2d),
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class StreamingMatrix:
    """Standardized genotype operator streamed from the host per pass.

    `strip_source(i)` returns host arrays for strip i:
      dense  - (geno int8 (S, N), mean (S,), std (S,)), -127 missing;
      packed - (PLINK bytes uint8 (S, ceil(N/4)), mean (S,), std (S,)),
               trailing fields sanitized (`sanitize_partial_byte`);
    with S <= `strip_size` rows (strip i holds matrix rows
    [i * strip_size, ...)).  Rows and columns pad here with inert values
    (missing genotypes, inv_std 0).  Implements
    ops.operator.StandardizedOperator on (n_samples, l) bases: every pass
    of the core (models/pca.py) streams the strips once.
    """

    # Device bytes that `tsq_and_project` may keep of per-strip A B
    # products; past it `ritz_gram` brings them to the host.
    _CAPTURE_DEVICE_BUDGET = 6 << 30

    def __init__(
        self,
        strip_source: Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray]],
        n_strips: int,
        n_rows: int,
        n_samples: int,
        strip_size: int,
        mode: Optional[str] = None,
        tile_d: int = 1024,
        kernel_precision: str = "q8",
        packed: bool = False,
        device="cuda",
        q8_polish: Optional[int] = None,
        missing_fraction: Optional[float] = None,
    ):
        if kernel_precision not in ("q8", "bf16", "f32"):
            raise ValueError(f"unknown kernel_precision {kernel_precision!r}")
        if mode not in (None, "1d", "2d"):
            raise ValueError(f"mode must be None, '1d' or '2d', got {mode!r}")
        self.device = torch.device(device)
        self._source = strip_source
        self.n_strips = n_strips
        self.n_rows = n_rows
        self.n_samples = n_samples
        self.strip_size = strip_size
        self.packed = packed
        self.n_cols = packed_cols(n_samples) if packed else dense_cols(n_samples)
        self.n_pad = 4 * self.n_cols if packed else self.n_cols
        self.kernel_precision = kernel_precision
        self.exact_precision = "bf16" if kernel_precision == "q8" else kernel_precision
        self.mode = mode or default_mode(self.n_pad, kernel_precision, packed)
        # The q8 quantization tile: a multiple of 64 no longer than a strip.
        self.tile_d = min(tile_d, _round_up(strip_size, 64))
        self.q8_polish = resolve_q8_polish(q8_polish, missing_fraction)
        self._right, self._left, self._gram1d, self._q8 = _STRIP_KERNELS[
            (packed, self.mode)]
        self._staging = None  # (pinned host, device) buffer pairs, 2 slots
        self._copy_stream = None
        self.pass_log: List[Dict] = []
        self.last_telemetry: Optional[Dict] = None
        self.rank, self.world = mesh.process_index(), mesh.process_count()
        self.own_strips = list(range(self.rank, n_strips, self.world))
        self._workers = max(1, PREFETCH_WORKERS // mesh.local_world_size())
        log.info("Host-streamed container: %d strips of %d rows, %s, mode %s, "
                 "%s on %s; rank %d/%d streams %d of them.", n_strips,
                 strip_size, "packed" if packed else "dense int8", self.mode,
                 kernel_precision, self.device, self.rank, self.world,
                 len(self.own_strips))

    # ------------------------------------------------------------------
    def _fetch(self, i: int):
        """Host payload of strip i, padded to (strip_size, n_cols): runs on
        a prefetch worker thread."""
        g, m, s = self._source(i)
        dtype = np.uint8 if self.packed else np.int8
        fill = PACKED_MISSING_BYTE if self.packed else MISSING
        g = np.asarray(g, dtype=dtype)
        rows = g.shape[0]
        out = np.full((self.strip_size, self.n_cols), fill, dtype=dtype)
        out[:rows, : g.shape[1]] = g
        mean = np.zeros((self.strip_size, 1), dtype=np.float32)
        inv = np.zeros((self.strip_size, 1), dtype=np.float32)
        mean[:rows, 0] = np.asarray(m, dtype=np.float32)
        inv[:rows, 0] = inv_std_of(np.asarray(s, dtype=np.float32))
        return (out, mean, inv), out.nbytes + mean.nbytes + inv.nbytes

    def _buffers(self):
        """Two slots of (pinned host, device) buffers for (geno, mean,
        inv_std), made at the first pass on a CUDA device and reused."""
        if self._staging is None:
            dt = torch.uint8 if self.packed else torch.int8
            shapes = ((self.strip_size, self.n_cols, dt),
                      (self.strip_size, 1, torch.float32),
                      (self.strip_size, 1, torch.float32))
            self._staging = [
                [(torch.empty(r, c, dtype=t, pin_memory=True),
                  torch.empty(r, c, dtype=t, device=self.device))
                 for r, c, t in shapes]
                for _ in range(2)
            ]
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._staging

    def _strips(self, name: str):
        """Yield (i, geno, mean, inv_std) device tensors of this rank's
        strips i in order.  A yielded strip stays valid until the consumer
        asks for the next but one; telemetry of the pass is taken when it
        ends."""
        t0 = time.perf_counter()
        own = self.own_strips
        p = StripPrefetcher(lambda j: self._fetch(own[j]), len(own),
                            depth=PREFETCH_DEPTH, max_workers=self._workers)
        cuda = self.device.type == "cuda"
        timed = []  # per strip: (copy start, copy end, stall start, stall end)
        n_bytes = 0
        try:
            if not cuda:
                for j, payload in enumerate(p):
                    n_bytes += sum(x.nbytes for x in payload)
                    yield (own[j], *(torch.from_numpy(x) for x in payload))
            else:
                slots = self._buffers()
                compute = torch.cuda.current_stream(self.device)
                done = [None, None]  # per slot: the compute event of its last strip
                for j, payload in enumerate(p):
                    slot = slots[j % 2]
                    if done[j % 2] is not None:
                        # The pinned buffer's last copy has finished once the
                        # kernels that read its device twin were enqueued
                        # after it; wait for that copy on the host.
                        timed[j - 2][1].synchronize()
                    for (host, _), x in zip(slot, payload):
                        host.numpy()[...] = x
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                    with torch.cuda.stream(self._copy_stream):
                        if done[j % 2] is not None:
                            self._copy_stream.wait_event(done[j % 2])
                        ev[0].record(self._copy_stream)
                        for host, dev in slot:
                            dev.copy_(host, non_blocking=True)
                        ev[1].record(self._copy_stream)
                    ev[2].record(compute)
                    compute.wait_event(ev[1])
                    ev[3].record(compute)
                    timed.append(ev)
                    n_bytes += sum(host.nbytes for host, _ in slot)
                    yield (own[j], *(dev for _, dev in slot))
                    done[j % 2] = torch.cuda.Event()
                    done[j % 2].record(compute)
                torch.cuda.synchronize(self.device)
        finally:
            p.close()
        secs = time.perf_counter() - t0
        copy_s = sum(a.elapsed_time(b) for a, b, _, _ in timed) / 1e3 if cuda else None
        wait_s = sum(c.elapsed_time(d) for _, _, c, d in timed) / 1e3 if cuda else None
        self.last_telemetry = {
            "pass": name, "strips": len(own), "bytes": n_bytes,
            "seconds": secs, "copy_seconds": copy_s,
            "copy_gbps": (n_bytes / copy_s / 1e9) if copy_s else None,
            "compute_wait_seconds": wait_s,
            "prefetch_consumer_waits": p.telemetry.consumer_waits,
        }
        self.pass_log.append(self.last_telemetry)
        if cuda:
            log.info("Streamed pass %s: %d strips, %.1f MiB uploaded in %.3f s "
                     "(copies %.4f s, %.2f GB/s; compute stream waited %.4f s).",
                     name, len(own), n_bytes / 2**20, secs, copy_s,
                     self.last_telemetry["copy_gbps"] or 0.0, wait_s)

    def _real_rows(self, i: int) -> int:
        return min(self.strip_size, self.n_rows - i * self.strip_size)

    def _pad_b(self, b) -> torch.Tensor:
        b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
        out = torch.zeros((self.n_pad, b.shape[1]), dtype=torch.float32,
                          device=self.device)
        out[: b.shape[0]] = b
        return out

    # ---- one strip ----------------------------------------------------
    def _strip_right(self, g, m, iv, bp):
        return self._right(g, m, iv, bp, self.exact_precision)

    def _strip_gram(self, g, m, iv, bp):
        if self._gram1d is not None:
            return self._gram1d(g, m, iv, bp, self.exact_precision)
        w = self._right(g, m, iv, bp, self.exact_precision)
        return self._left(g, m, iv, w, self.exact_precision)

    def _strip_gram_q8(self, g, m, iv, bq, sb, csum):
        """One strip's partial of T = A^T A b with the rank-1 term already
        folded (linear, so the fold commutes with the strip sum)."""
        out, ru = self._q8(g, iv, m * iv, bq, sb, csum, tile_d=self.tile_d)
        return out - ru

    # ---- merging over the ranks ---------------------------------------
    def _merge(self, acc: Optional[torch.Tensor], shape) -> torch.Tensor:
        """The sum over the ranks of this rank's partial sum `acc` (exact
        zeros of `shape` on a rank without strips): one all-reduce, its
        host-clock seconds in the pass's telemetry."""
        if acc is None:
            acc = torch.zeros(shape, dtype=torch.float32, device=self.device)
        if self.world == 1:
            return acc
        t0 = time.perf_counter()
        acc = mesh.all_reduce_sum(acc)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_telemetry["all_reduce_seconds"] = time.perf_counter() - t0
        return acc

    def _gather_rows(self, rows: Dict[int, np.ndarray], cols: int) -> np.ndarray:
        """Rows out on the host in global row order, the same on every
        rank: `rows` maps each of this rank's strips to its (real rows,
        cols) host block.  With several ranks the strips travel in rounds
        of at most 64 MiB a rank: in round t every rank passes its strips
        t g, ..., t g + g - 1 of `strip_size` rows (zeros past its own) to
        one gather, whose rank-major order interleaves back into the
        global strips [t g R, (t + 1) g R)."""
        if self.world == 1:
            return np.concatenate([rows[i] for i in self.own_strips])
        per = -(-self.n_strips // self.world)
        g = max(1, (64 << 20) // (self.strip_size * cols * 4))
        out = np.empty((per * self.world * self.strip_size, cols), np.float32)
        t0 = time.perf_counter()
        for j0 in range(0, per, g):
            n_j = min(g, per - j0)
            local = np.zeros((n_j, self.strip_size, cols), np.float32)
            for t, i in enumerate(self.own_strips[j0:j0 + n_j]):
                local[t, : rows[i].shape[0]] = rows[i]
            got = mesh.all_gather_rows(torch.from_numpy(local).to(mesh.comm_device()))
            got = got.reshape(self.world, n_j, self.strip_size, cols).transpose(0, 1)
            lo = j0 * self.world * self.strip_size
            out[lo:lo + n_j * self.world * self.strip_size] = (
                got.reshape(-1, cols).cpu().numpy())
        self.last_telemetry["all_gather_seconds"] = time.perf_counter() - t0
        return out[: self.n_rows]

    # ---- public passes ------------------------------------------------
    def gram_apply(self, b) -> torch.Tensor:
        """A^T (A B): (n_samples, l) on the device."""
        bp = self._pad_b(b)
        acc = None
        for _, g, m, iv in self._strips("gram"):
            part = self._strip_gram(g, m, iv, bp)
            acc = part if acc is None else acc + part
        return self._merge(acc, bp.shape)[: self.n_samples]

    def tsq_accumulate(self, b) -> torch.Tensor:
        """(A B)^T (A B): (l, l) on the device, W^T W of the f32 W."""
        bp = self._pad_b(b)
        acc = None
        for _, g, m, iv in self._strips("tsq"):
            w = self._strip_right(g, m, iv, bp)
            acc = w.T @ w if acc is None else acc + w.T @ w
        return self._merge(acc, (bp.shape[1], bp.shape[1]))

    def right_apply(self, b) -> np.ndarray:
        """A B on the host with padding removed: (n_rows, l)."""
        bp = self._pad_b(b)
        rows = {i: self._strip_right(g, m, iv, bp)[: self._real_rows(i)].cpu().numpy()
                for i, g, m, iv in self._strips("right")}
        return self._gather_rows(rows, bp.shape[1])

    def tsq_and_project(self, b):
        """One pass giving `tsq_accumulate(b)` and a `project(w) -> (n_rows,
        k)` host closure over the per-strip A B products, which stay on the
        device of their rank, so that the loadings (A B) W download as
        (n_rows, k).  None when the products of all strips would pass
        `_CAPTURE_DEVICE_BUDGET`."""
        if self.n_strips * self.strip_size * b.shape[1] * 4 > self._CAPTURE_DEVICE_BUDGET:
            return None
        acc, ws = self._tsq_keep(b, to_host=False)

        def project(w_small) -> np.ndarray:
            w_dev = torch.as_tensor(w_small, dtype=torch.float32, device=self.device)
            rows = {i: (w @ w_dev).cpu().numpy() for i, w in ws.items()}
            ws.clear()  # release the captured products
            return self._gather_rows(rows, w_dev.shape[1])

        return acc, project

    def _tsq_and_capture(self, b):
        """One pass giving `tsq_accumulate(b)` ((l, l), device) and A B
        ((n_rows, l), host)."""
        acc, rows = self._tsq_keep(b, to_host=True)
        return acc, self._gather_rows(rows, acc.shape[0])

    def _tsq_keep(self, b, to_host: bool):
        """One pass: `tsq_accumulate(b)` and {strip: its real rows of A B},
        kept on the device or brought to the host."""
        bp = self._pad_b(b)
        acc, rows = None, {}
        for i, g, m, iv in self._strips("tsq_capture"):
            w = self._strip_right(g, m, iv, bp)
            acc = w.T @ w if acc is None else acc + w.T @ w
            w = w[: self._real_rows(i)]
            rows[i] = w.cpu().numpy() if to_host else w
        return self._merge(acc, (bp.shape[1], bp.shape[1])), rows

    # ---- the passes of the core (models/pca.py), on (n_samples, l) bases --
    resident = False

    def basis(self, b) -> torch.Tensor:
        return torch.as_tensor(b, dtype=torch.float32, device=self.device)

    def q8_pass(self, b) -> torch.Tensor:
        """A^T A B through the q8 steering kernels: (n_samples, l)."""
        bp = self._pad_b(b)
        bq, sb, csum = quantize_basis(bp)
        acc = None
        for _, g, m, iv in self._strips("q8"):
            part = self._strip_gram_q8(g, m, iv, bq, sb, csum)
            acc = part if acc is None else acc + part
        return self._merge(acc, bp.shape)[: self.n_samples]

    def exact_pass(self, b) -> torch.Tensor:
        return self.gram_apply(b)

    def ritz_gram(self, q):
        """(A Q)^T (A Q), and `right(v, w)` = (A Q) W on the host, from one
        pass: A Q kept on the device within `_CAPTURE_DEVICE_BUDGET`
        (`tsq_and_project`), else brought to the host."""
        got = self.tsq_and_project(q)
        if got is not None:
            g, project = got
            return g, lambda v, w: torch.from_numpy(project(w))
        g, aq = self._tsq_and_capture(q)
        return g, lambda v, w: torch.from_numpy(aq @ w.cpu().numpy())

    def rows_to_host(self, rows: torch.Tensor) -> np.ndarray:
        return rows.numpy()
