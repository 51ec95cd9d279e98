"""genomic_pca_tpu_torch - the PyTorch + CUDA port of genomic_pca_tpu.

The JAX package beside it is the reference.  This package imports torch,
never jax and nothing of the JAX package (it keeps its own copies of the
jax-free modules it needs).  Its hot path is hand-written CUDA kernels for
Hopper (ops/kernels.py, sources in csrc/) over packed or dense genotypes,
driven by the resident randomized-PCA core of parallel/sharded.py or the
host-streamed container of ops/streaming.py.  Entry points: the VCF,
EigenSNP and projection workflows (`python -m genomic_pca_tpu_torch`).
"""

import torch

__version__ = "0.1.0"

# Float32 products in the glue (CholQR2, QR, eigh inputs, V = Q W) run in
# full f32, as the reference runs them at Precision.HIGHEST: no TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
