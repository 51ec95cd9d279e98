"""The benchmark's genotype generator: Balding-Nichols cohorts made on the
device from a seed, strip by strip.

Two population models, as a configuration's `model` names them:

- `balding_nichols`: `n_pops` populations drawn from one ancestral pool
  at `fst`; each sample drawn into population i with probability
  proportional to `size_ratio ** i`, so that the leading PCs are
  separated by eigengaps, or, where the model gives `shares` (one
  fraction a population, summing to 1), the samples split by those
  fractions in order, as a cohort of one dominant ancestry and small
  groups states its make-up;
- `hierarchical_balding_nichols`: superpopulations drawn from the
  ancestral pool at `fst_super`, and subpopulations drawn from their
  superpopulation at `fst_sub`, with the samples split evenly over the
  subpopulations in order (the 1000 Genomes layout).

Each SNP's ancestral frequency is uniform on `ancestral_range`; each
genotype is two Bernoulli draws at its population's frequency, and
`missing` of the calls are missing.  The per-SNP frequency table (SNPs x
populations) is drawn on the host; the genotypes, the bulk of the data,
are drawn on the device in strips of `strip_rows` rows, each strip from
its own generator seeded by (seed, strip), so any strip can be made
again alone: the reference reads the same bytes that the program read.

Rows are PLINK 1 bytes (SNP-major, four samples a byte, low bits first,
counting A1: dosage 2 -> 00, 1 -> 10, 0 -> 11, missing -> 01); the
trailing fields of the last byte are 01 (missing, inert).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

# Genotypes per strip: the strip's f32 temporaries are 512 MiB each.
STRIP_ELEMS = 1 << 27


def seed_words(seed: int, *words: int) -> int:
    """A 63-bit generator seed from the run's seed and further words."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), *words])
    return int(state.generate_state(1, np.uint64)[0]) & (2**63 - 1)


@dataclasses.dataclass
class Cohort:
    """A generated cohort: `freqs` (rows, P) f32 on the device for rows
    [row_lo, row_lo + rows) of the whole matrix, `pop_of` (N,) the
    population of each sample."""

    n_rows: int  # rows of the whole matrix
    n_samples: int
    row_lo: int
    freqs: torch.Tensor
    pop_of: torch.Tensor
    missing: float
    seed: int
    strip_rows: int

    @property
    def local_rows(self) -> int:
        return self.freqs.shape[0]

    def strips(self) -> Iterator[Tuple[int, int]]:
        """Local row ranges [lo, hi) of the strips, on the fixed grid."""
        for lo in range(0, self.local_rows, self.strip_rows):
            yield lo, min(lo + self.strip_rows, self.local_rows)


def strip_rows_for(n_samples: int) -> int:
    return max(1, STRIP_ELEMS // max(n_samples, 1))


def _bn(rng: np.random.Generator, p: np.ndarray, fst: float) -> np.ndarray:
    a = p * (1 - fst) / fst
    b = (1 - p) * (1 - fst) / fst
    return rng.beta(np.maximum(a, 1e-3), np.maximum(b, 1e-3))


def split_by_shares(n_samples: int, shares, n_pops: int) -> np.ndarray:
    """The population of each sample, in order: population i takes the
    samples from round(N (s_1 + ... + s_i-1)) to round(N (s_1 + ... +
    s_i)), so each count is within one of its share of N."""
    s = np.asarray(shares, dtype=np.float64)
    if s.shape != (n_pops,) or (s < 0).any() or abs(s.sum() - 1.0) > 1e-9:
        raise ValueError(f"shares {list(shares)} are not {n_pops} fractions summing to 1")
    edges = np.rint(np.concatenate([[0.0], np.cumsum(s)]) * n_samples).astype(np.int64)
    edges[-1] = n_samples
    return np.repeat(np.arange(n_pops), np.diff(edges))


def make_cohort(model: dict, n_rows: int, n_samples: int, seed: int, device,
                row_lo: int = 0, row_hi: Optional[int] = None) -> Cohort:
    """The cohort of `model` (a configuration's `model` object) for rows
    [row_lo, row_hi) of an (n_rows, n_samples) matrix.  The frequency
    table is drawn for every row, so a rank's rows are the same rows that
    one device would hold."""
    row_hi = n_rows if row_hi is None else row_hi
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0])
    lo_a, hi_a = model["ancestral_range"]
    anc = rng.uniform(lo_a, hi_a, size=n_rows)
    kind = model["kind"]
    if kind == "balding_nichols":
        n_pops = int(model["n_pops"])
        freqs = _bn(rng, anc[:, None].repeat(n_pops, 1), float(model["fst"]))
        if "shares" in model:
            pop_of = split_by_shares(n_samples, model["shares"], n_pops)
        else:
            w = float(model["size_ratio"]) ** np.arange(n_pops)
            pop_of = rng.choice(n_pops, size=n_samples, p=w / w.sum())
    elif kind == "hierarchical_balding_nichols":
        cols = []
        for n_sub in model["subpops"].values():
            sup = _bn(rng, anc, float(model["fst_super"]))
            cols.extend(_bn(rng, sup, float(model["fst_sub"])) for _ in range(n_sub))
        freqs = np.stack(cols, axis=1)
        per = np.full(len(cols), n_samples // len(cols))
        per[: n_samples - int(per.sum())] += 1
        pop_of = np.repeat(np.arange(len(cols)), per)
    else:
        raise ValueError(f"unknown population model {kind!r}")
    dev = torch.device(device)
    return Cohort(
        n_rows=n_rows, n_samples=n_samples, row_lo=row_lo,
        freqs=torch.as_tensor(freqs[row_lo:row_hi], dtype=torch.float32).to(dev),
        pop_of=torch.as_tensor(pop_of, dtype=torch.int64).to(dev),
        missing=float(model["missing"]), seed=int(seed),
        strip_rows=strip_rows_for(n_samples),
    )


def strip_codes(cohort: Cohort, lo: int, hi: int) -> torch.Tensor:
    """(hi - lo, N) uint8 2-bit codes of local rows [lo, hi), which must be
    a strip of the grid (`Cohort.strips`)."""
    if lo % cohort.strip_rows:
        raise ValueError(f"row {lo} is not on the strip grid of {cohort.strip_rows}")
    dev = cohort.freqs.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed_words(cohort.seed, 1, (cohort.row_lo + lo) // cohort.strip_rows))
    f = cohort.freqs[lo:hi][:, cohort.pop_of]
    shape = f.shape
    g = (torch.rand(shape, generator=gen, device=dev) < f).to(torch.uint8)
    g += (torch.rand(shape, generator=gen, device=dev) < f).to(torch.uint8)
    del f
    miss = torch.rand(shape, generator=gen, device=dev) < cohort.missing
    code = torch.where(g == 2, 0, 3 - g).to(torch.uint8)
    return code.masked_fill_(miss, 1)


def pack_codes(code: torch.Tensor) -> torch.Tensor:
    """(R, N) uint8 codes -> (R, ceil(N / 4)) PLINK bytes, the trailing
    fields 01."""
    r, n = code.shape
    n4 = -(-n // 4)
    if n4 * 4 != n:
        code = torch.cat([code, torch.ones((r, n4 * 4 - n), dtype=torch.uint8,
                                           device=code.device)], dim=1)
    c = code.reshape(r, n4, 4)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


def packed_strip(cohort: Cohort, lo: int, hi: int) -> torch.Tensor:
    return pack_codes(strip_codes(cohort, lo, hi))


def code_counts(code: torch.Tensor) -> torch.Tensor:
    """(R, 3) float64 (valid calls, dosage sum, sum of squared dosages)."""
    valid = code != 1
    dos = torch.where(valid, (4 - code.to(torch.int32)) >> 1, 0).to(torch.float64)
    return torch.stack([valid.sum(1, dtype=torch.float64), dos.sum(1),
                        (dos * dos).sum(1)], dim=1)


def moments(cohort: Cohort) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, sample std) f32 of every local row, over its valid calls,
    from exact counts: the moments a workflow hands the container."""
    counts = torch.empty((cohort.local_rows, 3), dtype=torch.float64,
                         device=cohort.freqs.device)
    for lo, hi in cohort.strips():
        counts[lo:hi] = code_counts(strip_codes(cohort, lo, hi))
    nv, s1, s2 = counts.cpu().numpy().T
    mean = s1 / np.maximum(nv, 1)
    var = np.where(nv >= 2, (s2 - nv * mean * mean) / np.maximum(nv - 1, 1), 0.0)
    return mean.astype(np.float32), np.sqrt(np.maximum(var, 0.0)).astype(np.float32)


def snp_positions(n_rows: int, seed: int, start: int, span: int) -> np.ndarray:
    """Strictly increasing base-pair positions of `n_rows` SNPs over
    [start, start + span): one position drawn in each of n_rows equal
    bins."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 2])
    width = span // n_rows
    if width < 1:
        raise ValueError(f"{n_rows} SNPs do not fit {span} base pairs")
    return start + np.arange(n_rows, dtype=np.int64) * width + rng.integers(
        0, width, size=n_rows)


def write_fileset(cohort: Cohort, prefix: str, chrom: str, bp: np.ndarray,
                  n_blocks: int) -> str:
    """Write the cohort as a PLINK 1 fileset (`prefix`.bed/.bim/.fam) and
    an LD-block file of `n_blocks` blocks of equal SNP count; returns the
    block file's path."""
    with open(prefix + ".bed", "wb") as fh:
        fh.write(bytes([0x6C, 0x1B, 0x01]))
        for lo, hi in cohort.strips():
            fh.write(packed_strip(cohort, lo, hi).cpu().numpy().tobytes())
    ids = np.char.add("rs", np.arange(cohort.n_rows).astype(str))
    bim = np.char.add(np.char.add(f"{chrom}\t", ids), "\t0\t")
    bim = np.char.add(np.char.add(bim, bp.astype(str)), "\tA\tG")
    with open(prefix + ".bim", "w") as fh:
        fh.write("\n".join(bim.tolist()) + "\n")
    with open(prefix + ".fam", "w") as fh:
        fh.write("".join(f"S{i:06d}\tS{i:06d}\t0\t0\t0\t-9\n"
                         for i in range(cohort.n_samples)))
    edges = np.linspace(0, cohort.n_rows, n_blocks + 1).astype(np.int64)
    path = prefix + ".blocks.tsv"
    with open(path, "w") as fh:
        for i in range(n_blocks):
            fh.write(f"{chrom} {bp[edges[i]]} {bp[edges[i + 1] - 1]}\n")
    return path
