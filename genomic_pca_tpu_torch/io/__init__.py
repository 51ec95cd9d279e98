"""Host-side IO of the port: PLINK, VCF/BGZF, LD blocks, TSV writers,
the native decode library and the strip prefetcher (copies of the JAX
package's jax-free `genomic_pca_tpu/io/` modules)."""
