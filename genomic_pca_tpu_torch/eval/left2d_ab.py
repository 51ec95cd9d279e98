"""A/B timing of the tensor-core left products (kernels 6 and 14) between
source trees, on one GPU.

    python -m genomic_pca_tpu_torch.eval.left2d_ab TAG

Run it from the root of each tree to compare (the kernels build from that
tree's `csrc/`), alternating the trees on one card, so that they share its
clocks and power limit.
It first holds both layouts to their plain versions at three small
shapes, with a second launch equal bit for bit; a tree that disagrees
exits 2 and is not timed.  Then it prints

    [TAG] packed <ms> dense <ms> thin packed <ms> thin dense <ms>

the mean time of back-to-back launches of the C entries at 65,536 x
16,384 (20 launches) and at 2,048 x 11,264 (200), L = 128, with W
already bf16 (the wrappers' host work excluded).  Exits 1 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from genomic_pca_tpu_torch.ops import build
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.parallel.sharded import pack_int8_rows

NAMES = {"packed": "fused_left_apply_2d_packed", "dense": "fused_left_apply_2d"}
ENTRIES = {"packed": "gp_left2d_packed", "dense": "gp_left2d_dense"}
CHECKS = ((40, 256, 10), (2100, 384, 130), (4096, 1024, 128))


def agrees(layout: str, d: int, n: int, ell: int, device, seed: int = 0) -> bool:
    """The kernel of `layout` against its plain version to 1e-5 of
    max|plain|, on dosages with 5% missing (dense: 2% outside {0, 1, 2}),
    and a second launch equal bit for bit."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    if layout == "dense":
        odd = rng.random(g.shape) < 0.02
        g[odd] = rng.integers(-100, 100, size=int(odd.sum()))
    g[rng.random(g.shape) < 0.05] = -127
    mu = rng.uniform(0.2, 1.8, size=(d, 1)).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, size=(d, 1)).astype(np.float32)
    w = rng.standard_normal((d, ell)).astype(np.float32)
    geno = pack_int8_rows(g) if layout == "packed" else g
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (geno, mu, inv, w)]
    kernel = getattr(tk, NAMES[layout])
    got, again = kernel(*args), kernel(*args)
    ref = tk.PLAIN[NAMES[layout]](*args, "bf16")
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    return err <= 1e-5 and bool(torch.equal(got, again))


def launch_ms(layout: str, d: int, n: int, reps: int) -> float:
    """Mean ms of `reps` back-to-back launches of the C entry on random
    bytes (the time does not depend on the genotypes)."""
    dev = torch.device("cuda")
    cols = n // 4 if layout == "packed" else n
    g = torch.randint(0, 256, (d, cols), device=dev, dtype=torch.uint8)
    if layout == "dense":
        g = (g % 3).to(torch.int8)
    mean = torch.rand((d, 1), device=dev)
    inv = torch.rand((d, 1), device=dev) + 0.5
    w = torch.randn((d, 128), device=dev).to(torch.bfloat16)
    out = torch.empty((n, 128), device=dev)
    entry = getattr(build.lib(), ENTRIES[layout])
    args = [g.data_ptr(), mean.data_ptr(), inv.data_ptr(), w.data_ptr(),
            out.data_ptr(), d, n // 4, 128, 128, 1,
            torch.cuda.current_stream().cuda_stream]
    for _ in range(3):
        if entry(*args) != 0:
            raise RuntimeError(f"{ENTRIES[layout]} refused the launch")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        entry(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("left2d_ab needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    bad = [(lay, *shape) for lay in NAMES for shape in CHECKS
           if not agrees(lay, *shape, dev)]
    for lay, d, n, ell in bad:
        print(f"[{a.tag}] FAIL {lay} D={d} N={n} L={ell}", flush=True)
    if bad:
        return 2
    print(f"[{a.tag}] packed {launch_ms('packed', 65_536, 16_384, 20):.4f} "
          f"dense {launch_ms('dense', 65_536, 16_384, 20):.4f} "
          f"thin packed {launch_ms('packed', 2_048, 11_264, 200):.4f} "
          f"thin dense {launch_ms('dense', 2_048, 11_264, 200):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
