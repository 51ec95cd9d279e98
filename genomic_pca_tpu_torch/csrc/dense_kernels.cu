// Dense int8 kernels of the 1-D mode: genotypes as one signed byte per
// sample, -127 missing (the JAX package's `packed_pipeline=False`
// container and `transform_device`).  They replace, in
// genomic_pca_tpu/ops/pallas_kernels.py:
//
//   fused_right_apply (:181, pallas_call :197)  -> f32 mode gp_right_dense;
//                                                  bf16 mode the tensor-core
//                                                  products of
//                                                  right1d_kernels.cu (L <= 16)
//                                                  or right2d_kernels.cu
//   fused_gram_apply  (:144, pallas_call :160)  -> gp_gram_dense (bf16 mode:
//                                                  the tensor-core products
//                                                  of gram.cuh); f32 mode
//                                                  gp_right_dense, then
//                                                  gp_left_dense
//   fused_tsq         (:215, pallas_call :231)  -> gp_tsq_dense (bf16 mode:
//                                                  the tensor-core products
//                                                  of gram.cuh); f32 mode
//                                                  gp_right_dense, then gp_wtw
//                                                  (exact_kernels.cu)
//   fused_gram_q8     (:847, pallas_call :863)  -> gp_q8_pass_dense
//                                                  (q8_kernels.cu)
//
// The f32 mode's passes run the FMA loops of packed_common.cuh (one block
// per 64 x 64 output tile; contractions over the variant axis split across
// block layers with f32 atomics), instantiated for DenseRows: the tile
// loader reads one aligned 32-bit word (four samples) per thread where the
// packed loader reads one byte.  Each pass reads D*N bytes, four times the
// packed bytes (512 MiB at 262,144 x 2,048: about 0.16 ms at 3.35 TB/s);
// the FMA loops are bound by their issue rate, the bf16 passes run on the
// tensor cores.
//
// Exact passes: valid = (g != -127); bf16 mode standardises as
// bf16(bf16(g * bf16(inv)) + bf16(-mean * inv)) (pallas_kernels.py
// :72-78), f32 mode as g * inv + (-mean * inv) (:79-82).
//
// Every entry point launches on the given stream and returns
// cudaGetLastError() so that a refused launch is never silent.
#include "gram.cuh"
#include "packed_common.cuh"

extern "C" {

// out (D, L) = A B; with round_out the W of the gram and tsq passes,
// rounded to bf16 as the reference rounds it.
int gp_right_dense(const void* geno, const void* mean, const void* inv_std,
                   const void* b, void* out, int D, int n4, int L, int bf16,
                   int round_out, void* stream) {
  return gp::launch_right(gp::DenseRows{(const int8_t*)geno, n4}, mean,
                          inv_std, b, out, D, L, bf16, round_out, stream);
}

// out (N, L) = A^T bf16(A B) over dense rows of n4 words, N samples (B's
// rows), b bf16 (N, ldb); `work` as gp_gram_plan sizes it.
int gp_gram_dense(const void* geno, const void* mean, const void* inv_std,
                  const void* b, void* out, void* work, int D, int n4, int N,
                  int L, int ldb, int sms, void* stream) {
  return gp::launch_gram(gp_right2d_w_dense, gp_left2d_dense, geno, mean,
                         inv_std, b, out, work, D, n4, N, L, ldb, sms, stream);
}

// out (L, L) = bf16(A B)^T bf16(A B) over dense rows of n4 words, N samples
// (B's rows), b bf16 (N, ldb); `work` as gp_tsq_plan sizes it.
int gp_tsq_dense(const void* geno, const void* mean, const void* inv_std,
                 const void* b, void* out, void* work, int D, int n4, int N,
                 int L, int ldb, int sms, void* stream) {
  return gp::launch_tsq(gp_right2d_w_dense, geno, mean, inv_std, b, out, work, D,
                        n4, N, L, ldb, sms, stream);
}

// out (N, L) += A^T W, split-K over `splits` row ranges.
int gp_left_dense(const void* geno, const void* mean, const void* inv_std,
                  const void* w, void* out, int D, int n4, int L, int bf16,
                  int splits, int rows_per_split, void* stream) {
  return gp::launch_left(gp::DenseRows{(const int8_t*)geno, n4}, mean, inv_std,
                         w, out, D, L, bf16, splits, rows_per_split, stream);
}

}  // extern "C"
