// Wide-sample (2-D mode) kernels: A^T W, G0 bq and sum_t sz_t G0_t^T z8_t,
// for both genotype layouts.
//
// They replace the 2-D tiled TPU kernels of genomic_pca_tpu/ops/
// pallas_kernels.py, which the JAX container picks once no full-width
// row tile fits VMEM (n_pad >= 11,264 packed samples, 11,136 dense):
//
//   fused_left_apply_2d_packed (:723, pallas_call :741) -> gp_left2d_packed
//   fused_left_apply_2d        (:346, pallas_call :363) -> gp_left2d_dense
//   right_apply_2d_q8  (:1096, pallas_call :1112), packed -> gp_q8_right2d
//                                      int8 (_clean_i8) -> gp_q8_right2d_dense
//   left_apply_2d_q8   (:1139, pallas_call :1158), packed -> gp_q8_left2d
//                                      int8 (_clean_i8) -> gp_q8_left2d_dense
//
// A B, the fourth kernel of the mode, is right_kernel of packed_common.cuh
// unrounded: gp_right_packed (exact_kernels.cu) for fused_right_apply_2d_packed
// and gp_right_dense (dense_kernels.cu) for fused_right_apply_2d.
//
// Each kernel is a template over the genotype layout (PackedRows,
// DenseRows of packed_common.cuh), as the 1-D main loops are: a packed
// byte and an aligned dense 32-bit word both hold a group of four samples,
// so the loaders read one group per thread and the loops are the same.
// The dense q8 kernels take G0 = max(g, 0) with __vmaxs4 (DenseRows::lanes)
// or per byte (DenseRows::dosage), so the -127 sentinel is raw 0.
//
// In the wide regime the sample axis alone fills the card: at 16,384
// samples there are 256 sample tiles of 64 x 2 column tiles of 64 = 512
// blocks for 132 SMs.  So each block of the two left products owns one
// (64 samples x 64 columns) output tile and loops over ALL variant rows
// itself: no split of the variant axis, no atomics, and the sum order is
// fixed (deterministic), unlike left_kernel / q8_left_kernel, which split
// the rows across block layers because 2,048 samples give too few tiles.
//
// Bound on an H100: the FMA / dp4a instruction rate (2 D N L operations per
// product against D N / 4 packed or D N dense bytes read), as in the 1-D
// kernels; no tensor cores yet.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError() so that a refused launch is never silent.
#include "packed_common.cuh"

namespace gp {

constexpr int kRowBlock = 1024;  // rows summed in a partial of left2d

// out (N, L) = A^T (N, D) . W (D, L), N = 4 * groups; one block per 64 x 64
// output tile, looping over every row.  W arrives in f32 and is rounded
// to the operand type on load (the reference rounds W to bf16 inside
// _left2d_packed_kernel and _left2d_kernel).  The sum over D runs in
// partials of kRowBlock rows added into a running total, so that its f32
// rounding grows with D / kRowBlock + kRowBlock terms rather than with D
// (a million rows at biobank scale).
template <class Rows>
__global__ void __launch_bounds__(kThreads)
left2d_kernel(Rows g, const float* __restrict__ mean,
              const float* __restrict__ inv_std, const float* __restrict__ w,
              float* __restrict__ out, int D, int L, int bf16) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int s0 = blockIdx.x * kBM, l0 = blockIdx.y * kBN;
  const int N = 4 * g.groups;
  // A loader: row ak of the chunk, group aq of the block's 16 groups.
  const int ak = tid >> 4, aq = tid & 15;
  const int jg = (s0 >> 2) + aq;

  float tot[4][4] = {};
  float acc[4][4] = {};
  for (int dc = 0; dc < D; dc += kBK) {
    if (dc % kRowBlock == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tot[i][j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    const int d = dc + ak;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (d < D && jg < g.groups) {
      const RowScale rs = row_scale(mean, inv_std, d, bf16);
      const uint32_t v = g.group(d, jg);
#pragma unroll
      for (int p = 0; p < 4; ++p) x[p] = standardized<Rows>(v, p, rs, bf16);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) As[ak][aq * 4 + p] = x[p];
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      const int dd = dc + k, l = l0 + n;
      const float v = (dd < D && l < L) ? w[(size_t)dd * L + l] : 0.f;
      Bs[k][n] = bf16 ? round_bf16(v) : v;
    }
    __syncthreads();
    fma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty + 16 * i;
    if (s >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = l0 + tx + 16 * j;
      if (c < L) out[(size_t)s * L + c] = tot[i][j] + acc[i][j];
    }
  }
}

// out (D, L) = G0 bq as f32: the int32 row sum converted once.  Exact
// while |sum| < 2^24, i.e. for up to about 66,000 samples; beyond that
// the single rounding of the exact int32 sum can differ from the
// reference, which adds per-tile int32 sums in f32.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
q8_right2d_kernel(Rows g, const int8_t* __restrict__ bq,
                  float* __restrict__ out, int D, int L) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d0 = blockIdx.x * kBM, l0 = blockIdx.y * kBN;
  int acc[4][4] = {};
  q8_right_tile(g, bq, D, L, d0, l0, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = d0 + ty + 16 * i;
    if (r >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = l0 + tx + 16 * j;
      if (c < L) out[(size_t)r * L + c] = __int2float_rn(acc[i][j]);
    }
  }
}

// out (N, L) = sum over row tiles t of sz[t] (G0_t^T z8_t).  Inside a
// tile the product is summed exactly in int32 (2 * 127 * tile_d < 2^31);
// sums under different scales cannot be added as integers, so at every
// tile boundary the int32 sum is scaled by that tile's sz and added to
// the f32 accumulator, in tile order.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
q8_left2d_kernel(Rows g, const int8_t* __restrict__ z8,
                 const float* __restrict__ sz, float* __restrict__ out, int D,
                 int L, int tile_d) {
  // Byte k of word row [m] holds variant row k of the chunk; the odd row
  // stride keeps the column reads of the inner loop off one bank.
  __shared__ int Aw[kBM][kQR / 4 + 1];
  __shared__ int Bw[kBN][kQR / 4 + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int s0 = blockIdx.x * kBM, l0 = blockIdx.y * kBN;
  const int n_tiles = (D + tile_d - 1) / tile_d;
  const int N = 4 * g.groups;
  const int ak = tid >> 4, aq = tid & 15;  // A loader: row, group
  const int jg = (s0 >> 2) + aq;
  int8_t* A8 = reinterpret_cast<int8_t*>(&Aw[0][0]);
  int8_t* B8 = reinterpret_cast<int8_t*>(&Bw[0][0]);
  constexpr int kRow = 4 * (kQR / 4 + 1);  // bytes per padded word row

  float facc[4][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int tstart = t * tile_d;
    const int tend = min(D, tstart + tile_d);
    const float scale = sz[t];
    int iacc[4][4] = {};
    for (int dc = tstart; dc < tend; dc += kQR) {
      const int d = dc + ak;
      uint32_t v = Rows::kMissing;  // all missing -> dosage 0
      if (d < tend && jg < g.groups) v = g.group(d, jg);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        A8[(aq * 4 + p) * kRow + ak] = (int8_t)Rows::dosage(v, p);
      for (int e = tid; e < kQR * kBN; e += kThreads) {
        const int k = e / kBN, n = e % kBN;
        const int dd = dc + k, l = l0 + n;
        B8[n * kRow + k] = (dd < tend && l < L) ? z8[(size_t)dd * L + l] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < kQR / 4; ++kw) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Aw[ty + 16 * i][kw];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bw[tx + 16 * j][kw];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            iacc[i][j] = __dp4a(a[i], b[j], iacc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        facc[i][j] = __fadd_rn(facc[i][j], __fmul_rn((float)iacc[i][j], scale));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty + 16 * i;
    if (s >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = l0 + tx + 16 * j;
      if (c < L) out[(size_t)s * L + c] = facc[i][j];
    }
  }
}

// Launchers shared by the packed and dense entry points.
template <class Rows>
int launch_left2d(Rows g, const void* mean, const void* inv_std, const void* w,
                  void* out, int D, int L, int bf16, void* stream) {
  left2d_kernel<Rows><<<grid_of(4 * g.groups, L), kThreads, 0,
                        (cudaStream_t)stream>>>(
      g, (const float*)mean, (const float*)inv_std, (const float*)w,
      (float*)out, D, L, bf16);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch_q8_right2d(Rows g, const void* bq, void* out, int D, int L,
                      void* stream) {
  q8_right2d_kernel<Rows><<<grid_of(D, L), kThreads, 0, (cudaStream_t)stream>>>(
      g, (const int8_t*)bq, (float*)out, D, L);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch_q8_left2d(Rows g, const void* z8, const void* sz, void* out, int D,
                     int L, int tile_d, void* stream) {
  q8_left2d_kernel<Rows><<<grid_of(4 * g.groups, L), kThreads, 0,
                           (cudaStream_t)stream>>>(
      g, (const int8_t*)z8, (const float*)sz, (float*)out, D, L, tile_d);
  return (int)cudaGetLastError();
}

}  // namespace gp

extern "C" {

// out (N, L) = A^T W over packed rows of n4 bytes / dense rows of n4 words.
int gp_left2d_packed(const void* packed, const void* mean, const void* inv_std,
                     const void* w, void* out, int D, int n4, int L, int bf16,
                     void* stream) {
  return gp::launch_left2d(gp::PackedRows{(const uint8_t*)packed, n4}, mean,
                           inv_std, w, out, D, L, bf16, stream);
}

int gp_left2d_dense(const void* geno, const void* mean, const void* inv_std,
                    const void* w, void* out, int D, int n4, int L, int bf16,
                    void* stream) {
  return gp::launch_left2d(gp::DenseRows{(const int8_t*)geno, n4}, mean,
                           inv_std, w, out, D, L, bf16, stream);
}

// out (D, L) = G0 bq, the integer sums converted to f32 once.
int gp_q8_right2d(const void* packed, const void* bq, void* out, int D, int n4,
                  int L, void* stream) {
  return gp::launch_q8_right2d(gp::PackedRows{(const uint8_t*)packed, n4}, bq,
                               out, D, L, stream);
}

int gp_q8_right2d_dense(const void* geno, const void* bq, void* out, int D,
                        int n4, int L, void* stream) {
  return gp::launch_q8_right2d(gp::DenseRows{(const int8_t*)geno, n4}, bq, out,
                               D, L, stream);
}

// out (N, L) = sum_t sz[t] G0_t^T z8_t.
int gp_q8_left2d(const void* packed, const void* z8, const void* sz, void* out,
                 int D, int n4, int L, int tile_d, void* stream) {
  return gp::launch_q8_left2d(gp::PackedRows{(const uint8_t*)packed, n4}, z8,
                              sz, out, D, L, tile_d, stream);
}

int gp_q8_left2d_dense(const void* geno, const void* z8, const void* sz,
                       void* out, int D, int n4, int L, int tile_d,
                       void* stream) {
  return gp::launch_q8_left2d(gp::DenseRows{(const int8_t*)geno, n4}, z8, sz,
                              out, D, L, tile_d, stream);
}

}  // extern "C"
