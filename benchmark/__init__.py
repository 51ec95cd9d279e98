"""The benchmark of `genomic_pca_tpu_torch`: `python3 -m benchmark.run` (see README.md)."""
