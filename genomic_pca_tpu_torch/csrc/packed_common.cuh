// Shared device code of the genotype kernels: the two genotype layouts,
// the per-SNP standardisation, the register-tiled FMA step, and the main
// loops of the f32 mode's passes, written once over the layout and
// instantiated for packed input (exact_kernels.cu) and for dense int8 input
// (dense_kernels.cu).
//
// Layouts, both in original sample order (no permutation): a row-major
// (D, G) matrix of GROUPS of four samples, group j of row d holding samples
// 4j..4j+3.  A loader reads one group per thread per chunk, so the main
// loops are the same for both.
//   PackedRows: PLINK 2-bit, one byte per group, sample 4j+p in bits
//     2p..2p+1; count_A1 codes 00 -> 2, 01 -> missing, 10 -> 1, 11 -> 0;
//     column padding bytes 0x55 (all missing).
//   DenseRows: int8 dosages, -127 missing, one 32-bit word per group
//     (sample 4j+p in byte p); the row stride is G words, so each group is
//     one aligned 4-byte load (the wrapper requires N % 4 == 0 and a
//     4-byte-aligned base).  Column padding is -127.
// Rows at or beyond D, and missing genotypes, standardise to 0.
//
// A = diag(inv_std) (G - mean) with missing entries 0.  In bf16 mode the
// scale and shift are rounded to bf16, then g * scale and the sum, as the
// TPU kernels' bf16 tile computes them (ops/pallas_kernels.py
// _standardize_tile :72-78 and _standardize_packed_tile); for packed
// dosages {0, 1, 2} the first rounding is exact.  Products of bf16 values
// are exact in f32 and all sums are f32, so an f32 FMA loop over
// bf16-rounded operands is the bf16-operand / f32-accumulate contract of
// the reference.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gp {

// Block tile shared by every kernel: 64 x 64 outputs per block of 256
// threads, 4 x 4 outputs per thread at (ty + 16 i, tx + 16 j).
constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;

__device__ __forceinline__ int code_at(uint32_t byte, int p) {
  return (byte >> (2 * p)) & 3;
}

// Dosage of a 2-bit code with missing -> 0: {0,1,2,3} -> {2,0,1,0}.
__device__ __forceinline__ int dosage_of(int c) {
  return c == 1 ? 0 : (4 - c) >> 1;
}

struct PackedRows {
  const uint8_t* p;
  int groups;  // bytes per row
  static constexpr int kGroupBytes = 1;
  static constexpr uint32_t kMissing = 0x55u;
  __device__ __forceinline__ uint32_t group(int d, int j) const {
    return p[(size_t)d * groups + j];
  }
  __device__ __forceinline__ static bool valid(uint32_t g, int q) {
    return code_at(g, q) != 1;
  }
  __device__ __forceinline__ static int value(uint32_t g, int q) {
    return dosage_of(code_at(g, q));
  }
};

struct DenseRows {
  const int8_t* p;
  int groups;  // 32-bit words per row (samples / 4)
  static constexpr int kGroupBytes = 4;
  static constexpr uint32_t kMissing = 0x81818181u;  // four -127 bytes
  __device__ __forceinline__ uint32_t group(int d, int j) const {
    return reinterpret_cast<const uint32_t*>(p)[(size_t)d * groups + j];
  }
  __device__ __forceinline__ static int value(uint32_t g, int q) {
    return (int)(int8_t)(g >> (8 * q));
  }
  __device__ __forceinline__ static bool valid(uint32_t g, int q) {
    return value(g, q) != -127;
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct RowScale {
  float sc;  // inv_std
  float sh;  // -mean * inv_std
};

__device__ __forceinline__ RowScale row_scale(const float* mean,
                                              const float* inv_std, int d,
                                              bool bf16) {
  const float iv = inv_std[d];
  const float sh = __fmul_rn(-mean[d], iv);
  if (bf16) return {round_bf16(iv), round_bf16(sh)};
  return {iv, sh};
}

// Standardised value of sample q of a group; missing -> 0.  The explicit
// _rn intrinsics keep the multiply and the add as two roundings, as the
// reference computes them (no FMA contraction).
template <class Rows>
__device__ __forceinline__ float standardized(uint32_t grp, int q, RowScale s,
                                              bool bf16) {
  if (!Rows::valid(grp, q)) return 0.f;
  float x = __fmul_rn((float)Rows::value(grp, q), s.sc);
  if (bf16) x = round_bf16(x);
  x = __fadd_rn(x, s.sh);
  return bf16 ? round_bf16(x) : x;
}

// acc[i][j] += sum_k As[k][ty + 16 i] * Bs[k][tx + 16 j].
__device__ __forceinline__ void fma_tile(float (*As)[kBM], float (*Bs)[kBN],
                                         float acc[4][4], int tx, int ty) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// Exact passes.  Hopper blocks run in parallel where the TPU grid carried
// one accumulator, so the two contractions over the variant axis (A^T W,
// W^T W) split that axis into ranges, one per block layer, and add their
// partial tiles into a zeroed output with f32 atomics: results agree to f32
// rounding, not bit for bit.

// out (D, L) = A (D, N) . B (N, L), N = 4 * groups.  One block per 64 x 64
// output tile, looping over the samples 16 at a time.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
right_kernel(Rows g, const float* __restrict__ mean,
             const float* __restrict__ inv_std, const float* __restrict__ b,
             float* __restrict__ out, int D, int L, int bf16, int round_out) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d0 = blockIdx.x * kBM, l0 = blockIdx.y * kBN;
  const int N = 4 * g.groups;
  // A loader: one group (4 samples) of one row per thread.
  const int ar = tid >> 2, aq = tid & 3;
  const int d = d0 + ar;
  const bool row_ok = d < D;
  RowScale rs = {0.f, 0.f};
  if (row_ok) rs = row_scale(mean, inv_std, d, bf16);

  float acc[4][4] = {};
  for (int s0 = 0; s0 < N; s0 += kBK) {
    const int j = (s0 >> 2) + aq;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row_ok && j < g.groups) {
      const uint32_t v = g.group(d, j);
#pragma unroll
      for (int p = 0; p < 4; ++p) x[p] = standardized<Rows>(v, p, rs, bf16);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) As[aq * 4 + p][ar] = x[p];
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      const int s = s0 + k, l = l0 + n;
      const float v = (s < N && l < L) ? b[(size_t)s * L + l] : 0.f;
      Bs[k][n] = bf16 ? round_bf16(v) : v;
    }
    __syncthreads();
    fma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = d0 + ty + 16 * i;
    if (r >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = l0 + tx + 16 * j;
      if (c < L) out[(size_t)r * L + c] = round_out ? round_bf16(acc[i][j]) : acc[i][j];
    }
  }
}

// out (N, L) += A^T (N, D) . W (D, L) over rows [z * rows_per_split, ...).
// W arrives already rounded to the operand type.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
left_kernel(Rows g, const float* __restrict__ mean,
            const float* __restrict__ inv_std, const float* __restrict__ w,
            float* __restrict__ out, int D, int L, int bf16,
            int rows_per_split) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int s0 = blockIdx.x * kBM, l0 = blockIdx.y * kBN;
  const int dlo = blockIdx.z * rows_per_split;
  const int dhi = min(D, dlo + rows_per_split);
  const int N = 4 * g.groups;
  // A loader: row ak of the chunk, group aq of the block's 16 groups.
  const int ak = tid >> 4, aq = tid & 15;
  const int j = (s0 >> 2) + aq;

  float acc[4][4] = {};
  for (int dc = dlo; dc < dhi; dc += kBK) {
    const int d = dc + ak;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (d < dhi && j < g.groups) {
      const RowScale rs = row_scale(mean, inv_std, d, bf16);
      const uint32_t v = g.group(d, j);
#pragma unroll
      for (int p = 0; p < 4; ++p) x[p] = standardized<Rows>(v, p, rs, bf16);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) As[ak][aq * 4 + p] = x[p];
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      const int dd = dc + k, l = l0 + n;
      Bs[k][n] = (dd < dhi && l < L) ? w[(size_t)dd * L + l] : 0.f;
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
    for (int jj = 0; jj < 4; ++jj) {
      const int c = l0 + tx + 16 * jj;
      if (c < L) atomicAdd(&out[(size_t)s * L + c], acc[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers shared by the packed and dense entry points.  Each launches on
// the given stream and returns cudaGetLastError(), so that a refused launch
// is never silent.

inline dim3 grid_of(int rows, int cols, int splits = 1) {
  return dim3((rows + kBM - 1) / kBM, (cols + kBN - 1) / kBN, splits);
}

template <class Rows>
int launch_right(Rows g, const void* mean, const void* inv_std, const void* b,
                 void* out, int D, int L, int bf16, int round_out,
                 void* stream) {
  right_kernel<Rows><<<grid_of(D, L), kThreads, 0, (cudaStream_t)stream>>>(
      g, (const float*)mean, (const float*)inv_std, (const float*)b,
      (float*)out, D, L, bf16, round_out);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch_left(Rows g, const void* mean, const void* inv_std, const void* w,
                void* out, int D, int L, int bf16, int splits,
                int rows_per_split, void* stream) {
  left_kernel<Rows><<<grid_of(4 * g.groups, L, splits), kThreads, 0,
                      (cudaStream_t)stream>>>(
      g, (const float*)mean, (const float*)inv_std, (const float*)w,
      (float*)out, D, L, bf16, rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace gp
