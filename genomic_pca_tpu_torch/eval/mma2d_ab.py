"""A/B timing of the tensor-core products between source trees, on one
GPU: the left products A^T W (kernels 6 and 14) and the right products
A B (kernels 5 and 13).

    python -m genomic_pca_tpu_torch.eval.mma2d_ab TAG

Run it from the root of each tree to compare (the kernels build from that
tree's `csrc/`), alternating the trees on one card, so that they share its
clocks and power limit.
It first holds each product of each layout to its plain version at small
shapes (ragged ones, and for the right products a strip whose samples
split), with a second launch equal bit for bit; a tree that disagrees
exits 2 and is not timed.  Then it prints two lines,

    [TAG] left packed <ms> dense <ms> thin packed <ms> thin dense <ms>
    [TAG] right packed <ms> dense <ms> strip packed <ms> dense <ms> thin
          packed <ms> dense <ms> L=10 packed <ms> dense <ms> fma strip
          packed <ms> dense <ms>

the mean time of back-to-back launches of the C entries (the wrappers'
host work excluded: W and B already bf16), L = 128 unless named: at
65,536 x 16,384 (20 launches), the left products at 2,048 x 11,264 (200),
the right ones at 2,000 x 16,384 (an EigenSNP strip, 200) and 2,048 x
11,264 (200), and at 65,536 x 16,384 with L = 10 (the loadings launch,
20).  "fma strip" is the f32 FMA loop the right products launched before
they ran on the tensor cores (gp_right_packed / gp_right_dense in bf16
mode; the f32 mode's kernel) at 2,000 x 16,384.  Exits 1 without a CUDA
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

NAMES = {
    ("left", "packed"): "fused_left_apply_2d_packed",
    ("left", "dense"): "fused_left_apply_2d",
    ("right", "packed"): "fused_right_apply_2d_packed",
    ("right", "dense"): "fused_right_apply_2d",
}
CHECKS = {
    "left": ((40, 256, 10), (2100, 384, 130), (4096, 1024, 128)),
    "right": ((40, 256, 10), (300, 2100, 130), (4096, 1024, 128)),
}
LAYOUTS = ("packed", "dense")


def agrees(product: str, layout: str, d: int, n: int, ell: int, device,
           seed: int = 0) -> bool:
    """The kernel of `product` and `layout` against its plain version to
    1e-5 of max|plain|, on dosages with 5% missing (dense: 2% outside {0,
    1, 2}), and a second launch equal bit for bit."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    if layout == "dense":
        odd = rng.random(g.shape) < 0.02
        g[odd] = rng.integers(-100, 100, size=int(odd.sum()))
    g[rng.random(g.shape) < 0.05] = -127
    mu = rng.uniform(0.2, 1.8, size=(d, 1)).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, size=(d, 1)).astype(np.float32)
    geno = pack_int8_rows(g) if layout == "packed" else g
    k = d if product == "left" else 4 * -(-n // 4)
    x = rng.standard_normal((k, ell)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (geno, mu, inv, x)]
    name = NAMES[product, layout]
    kernel = getattr(tk, name)
    got, again = kernel(*args), kernel(*args)
    ref = tk.PLAIN[name](*args, "bf16")
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    return err <= 1e-5 and bool(torch.equal(got, again))


def launch_ms(product: str, layout: str, d: int, n: int, reps: int,
              ell: int = 128, fma: bool = False) -> float:
    """Mean ms of `reps` back-to-back launches of the C entry on random
    bytes (the time does not depend on the genotypes); `fma`: the right
    product's f32 FMA loop in bf16 mode."""
    dev = torch.device("cuda")
    cols = n // 4 if layout == "packed" else n
    g = torch.randint(0, 256, (d, cols), device=dev, dtype=torch.uint8)
    if layout == "dense":
        g = (g % 3).to(torch.int8)
    mean = torch.rand((d, 1), device=dev)
    inv = torch.rand((d, 1), device=dev) + 0.5
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.lib()
    if product == "left":
        x = torch.randn((d, ell), device=dev)
        out = torch.empty((n, ell), device=dev)
        entry = getattr(lib, tk._ENTRY[g.dtype]["left2d"])
        args = [x.to(torch.bfloat16), out, d, n // 4, ell, ell, 1]
    else:
        x = torch.randn((n, ell), device=dev)
        out = torch.empty((d, ell), device=dev)
        if fma:
            entry = getattr(lib, tk._ENTRY[g.dtype]["right"])
            args = [x, out, d, n // 4, ell, 1, 0]
        else:
            entry = getattr(lib, tk._ENTRY[g.dtype]["right2d"])
            sms = tk._sms(dev)
            b = tk.mma_operand(x)
            splits = tk.right2d_plan(d, n, ell, sms)[2]
            slab = torch.empty((splits, d, ell), device=dev) if splits > 1 else None
            args = [b, out, slab, d, n // 4, n, ell, b.shape[1], sms]
    args = [a.data_ptr() if torch.is_tensor(a) else a
            for a in [g, mean, inv, *args, stream]]
    for _ in range(3):
        if entry(*args) != 0:
            raise RuntimeError(f"{product} {layout} refused the launch")
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
        print("mma2d_ab needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    bad = [(prod, lay, *shape) for prod, lay in NAMES for shape in CHECKS[prod]
           if not agrees(prod, lay, *shape, dev)]
    for prod, lay, d, n, ell in bad:
        print(f"[{a.tag}] FAIL {prod} {lay} D={d} N={n} L={ell}", flush=True)
    if bad:
        return 2

    def each(product, d, n, reps, **kw):
        return " ".join(f"{lay} {launch_ms(product, lay, d, n, reps, **kw):.4f}"
                        for lay in LAYOUTS)

    print(f"[{a.tag}] left {each('left', 65_536, 16_384, 20)} "
          f"thin {each('left', 2_048, 11_264, 200)}", flush=True)
    print(f"[{a.tag}] right {each('right', 65_536, 16_384, 20)} "
          f"strip {each('right', 2_000, 16_384, 200)} "
          f"thin {each('right', 2_048, 11_264, 200)} "
          f"L=10 {each('right', 65_536, 16_384, 20, ell=10)} "
          f"fma strip {each('right', 2_000, 16_384, 20, fma=True)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
