// Exact (bf16 or f32 operand) packed kernels: A B, A^T W and W^T W, and
// the entries of the 1-D gram and tsq passes in bf16 mode.
//
// The main loops of A B and A^T W are those of packed_common.cuh,
// instantiated for the PLINK 2-bit layout; W^T W (wtw_kernel) takes no
// genotypes and also serves the dense tsq pass (dense_kernels.cu).  The
// contractions over the variant axis split it across block layers with f32
// atomics.  They serve f32 mode ("HIGHEST" in the reference); in bf16 mode
// the right product fused_right_apply_packed is right1d_kernels.cu's (L <=
// 16) or right2d_kernels.cu's, and the gram pass
// fused_gram_apply_packed (pallas_kernels.py :492, pallas_call :508; body
// _gram_packed_kernel :447) is gp_gram_packed and the tsq pass
// fused_tsq_packed (:564, pallas_call :580; body _tsq_packed_kernel :472)
// is gp_tsq_packed: the tensor-core products of right2d_kernels.cu,
// wide_kernels.cu and wtw_kernels.cu, composed in gram.cuh.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError() so that a refused launch is never silent.
#include "gram.cuh"
#include "packed_common.cuh"

namespace gp {

// out (L, L) += W^T W over rows [z * rows_per_split, ...).
__global__ void __launch_bounds__(kThreads)
wtw_kernel(const float* __restrict__ w, float* __restrict__ out, int D,
           int L, int rows_per_split) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int dlo = blockIdx.z * rows_per_split;
  const int dhi = min(D, dlo + rows_per_split);

  float acc[4][4] = {};
  for (int dc = dlo; dc < dhi; dc += kBK) {
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int k = e / kBM, m = e % kBM;
      const int dd = dc + k;
      As[k][m] = (dd < dhi && m0 + m < L) ? w[(size_t)dd * L + m0 + m] : 0.f;
      Bs[k][m] = (dd < dhi && n0 + m < L) ? w[(size_t)dd * L + n0 + m] : 0.f;
    }
    __syncthreads();
    fma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < L) atomicAdd(&out[(size_t)r * L + c], acc[i][j]);
    }
  }
}

}  // namespace gp

extern "C" {

int gp_right_packed(const void* packed, const void* mean, const void* inv_std,
                    const void* b, void* out, int D, int n4, int L, int bf16,
                    int round_out, void* stream) {
  return gp::launch_right(gp::PackedRows{(const uint8_t*)packed, n4}, mean,
                          inv_std, b, out, D, L, bf16, round_out, stream);
}

int gp_left_packed(const void* packed, const void* mean, const void* inv_std,
                   const void* w, void* out, int D, int n4, int L, int bf16,
                   int splits, int rows_per_split, void* stream) {
  return gp::launch_left(gp::PackedRows{(const uint8_t*)packed, n4}, mean,
                         inv_std, w, out, D, L, bf16, splits, rows_per_split,
                         stream);
}

// out (4 n4, L) f32 = A^T bf16(A B) over packed rows of n4 bytes, N
// samples (B's rows), b bf16 (N, ldb); `work` as gp_gram_plan sizes it.
int gp_gram_packed(const void* packed, const void* mean, const void* inv_std,
                   const void* b, void* out, void* work, int D, int n4, int N,
                   int L, int ldb, int sms, void* stream) {
  return gp::launch_gram(gp_right2d_w_packed, gp_left2d_packed, packed, mean,
                         inv_std, b, out, work, D, n4, N, L, ldb, sms, stream);
}

// out (L, L) f32 = bf16(A B)^T bf16(A B) over packed rows of n4 bytes, N
// samples (B's rows), b bf16 (N, ldb); `work` as gp_tsq_plan sizes it.
int gp_tsq_packed(const void* packed, const void* mean, const void* inv_std,
                  const void* b, void* out, void* work, int D, int n4, int N,
                  int L, int ldb, int sms, void* stream) {
  return gp::launch_tsq(gp_right2d_w_packed, packed, mean, inv_std, b, out, work,
                        D, n4, N, L, ldb, sms, stream);
}

// The plans of the bf16 gram pass over D rows of n4 groups, N samples and
// L columns on `sms` SMs, either layout, into plan[0..10]: the right
// product's tile (rows, columns), grid (x, y) and sample splits; the left
// product's tile (samples, columns), grid (x, y) and row ranges; the
// workspace's bytes.
int gp_gram_plan(int D, int n4, int N, int L, int sms, long long* plan) {
  const gp::GramPlan p = gp::gram_plan(D, n4, N, L, sms);
  for (int i = 0; i < 5; ++i) {
    plan[i] = p.right[i];
    plan[5 + i] = p.left[i];
  }
  plan[10] = (long long)(p.w_bytes + p.slab_bytes);
  return 0;
}

// The plans of the bf16 tsq pass over D rows, N samples and L columns on
// `sms` SMs, either layout, into plan[0..10]: the right product's (the
// gram pass's: tile, grid, sample splits), W^T W's tile (rows, columns),
// grid (x, y) and row ranges, the workspace's bytes.  n4 is taken as
// gp_gram_plan takes it; the plan does not depend on it.
int gp_tsq_plan(int D, int n4, int N, int L, int sms, long long* plan) {
  (void)n4;
  const gp::TsqPlan p = gp::tsq_plan(D, N, L, sms);
  for (int i = 0; i < 5; ++i) {
    plan[i] = p.right[i];
    plan[5 + i] = p.wtw[i];
  }
  plan[10] = (long long)(p.w_bytes + p.slab_bytes);
  return 0;
}

int gp_wtw(const void* w, void* out, int D, int L, int splits,
           int rows_per_split, void* stream) {
  gp::wtw_kernel<<<gp::grid_of(L, L, splits), gp::kThreads, 0,
                   (cudaStream_t)stream>>>((const float*)w, (float*)out, D, L,
                                           rows_per_split);
  return (int)cudaGetLastError();
}

}  // extern "C"
