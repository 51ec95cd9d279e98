// Shared device code of the genotype kernels: the two genotype layouts,
// the per-SNP standardisation, the register-tiled FMA step, and the main
// loops of the 1-D passes, written once over the layout and instantiated
// for packed input (exact_kernels.cu, q8_kernels.cu) and for dense int8
// input (dense_kernels.cu).
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

// The four dosages of one byte as the four int8 lanes of a word
// (lane p = sample 4j + p), the __dp4a operand of the q8 kernels.
__device__ __forceinline__ int decode_word(uint32_t byte) {
  int w = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) w |= dosage_of(code_at(byte, p)) << (8 * p);
  return w;
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
  // G0, the dosage with missing -> 0, of one sample and of all four.
  __device__ __forceinline__ static int dosage(uint32_t g, int q) {
    return value(g, q);
  }
  __device__ __forceinline__ static int lanes(uint32_t g) {
    return decode_word(g);
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
  __device__ __forceinline__ static int dosage(uint32_t g, int q) {
    return max(value(g, q), 0);
  }
  // G0 = max(g, 0) in the four signed lanes at once: the -127 sentinel
  // becomes raw 0, and the word feeds __dp4a as it is.
  __device__ __forceinline__ static int lanes(uint32_t g) {
    return (int)__vmaxs4(g, 0u);
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
// Quantised (q8) steering pass, in two kernels.
//
// The TPU kernels (_gram_q8_kernel, _gram_q8_packed_kernel) do, per row
// tile of tile_d SNPs: W = G0 . bq (s8 x s8 -> s32), y = s (W sb) - u csum,
// z = s y, z8 = round(z / sz) with ONE sz = max|z| / 127 over the whole
// tile, out += (G0^T z8) sz and ru += sum_d u y.  The scale of a tile needs
// the whole (tile_d, L) block of z before the second product, and blocks
// here run in parallel, so the pass is split where that reduction sits:
//
//   q8_w_kernel    : W, y, z (stored f32), ru, and the per-tile max|z|
//                    (atomicMax on the float bits, all values >= 0);
//   q8_left_kernel : z8 from z and the tile's scale, the integer product
//                    G0^T z8 summed exactly in s32 inside each tile, then
//                    scaled and added in f32 across the tiles of a split,
//                    and across splits with f32 atomics.
//
// The integer products run on __dp4a: four int8 lanes of a word, the four
// samples of one group in the first kernel and four SNP rows in the
// second.

constexpr int kQW = 8;   // groups (32 samples) per chunk of q8_right_tile
constexpr int kQR = 16;  // SNP rows per chunk of the q8 left products

// acc[i][j] = sum over all samples of G0[d0 + ty + 16 i] . bq[:, l0 + tx + 16 j]:
// the raw integer product G0 bq of one 64 x 64 output tile.  Exact in
// int32 while 2 * 127 * N < 2^31.  Rows >= D and columns >= L read as 0.
template <class Rows>
__device__ __forceinline__ void q8_right_tile(Rows g,
                                              const int8_t* __restrict__ bq,
                                              int D, int L, int d0, int l0,
                                              int acc[4][4]) {
  __shared__ int Aw[kQW][kBM];
  __shared__ int Bw[kQW][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n4 = g.groups;
  for (int j0 = 0; j0 < n4; j0 += kQW) {
    for (int e = tid; e < kQW * kBM; e += kThreads) {
      const int k = e % kQW, m = e / kQW;
      const int d = d0 + m, j = j0 + k;
      Aw[k][m] = (d < D && j < n4) ? Rows::lanes(g.group(d, j)) : 0;
    }
    for (int e = tid; e < kQW * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      const int j = j0 + k, l = l0 + n;
      int wv = 0;
      if (j < n4 && l < L) {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          wv |= (int)(uint8_t)bq[(size_t)(4 * j + p) * L + l] << (8 * p);
      }
      Bw[k][n] = wv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kQW; ++k) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Aw[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bw[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// z (D, L) f32, ru (L) += sum_d u y, tile_max[d / tile_d] = max |z|.
// tile_d is a multiple of kBM, so a block's rows lie in one tile.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
q8_w_kernel(Rows g, const float* __restrict__ inv_std,
            const float* __restrict__ u, const int8_t* __restrict__ bq,
            const float* __restrict__ sb_ptr, const float* __restrict__ csum,
            float* __restrict__ z, unsigned int* __restrict__ tile_max,
            float* __restrict__ ru, int D, int L, int tile_d) {
  __shared__ float red[16][kBN];
  __shared__ float wmax[kThreads / 32];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d0 = blockIdx.x * kBM, l0 = blockIdx.y * kBN;

  int acc[4][4] = {};
  q8_right_tile(g, bq, D, L, d0, l0, acc);

  const float sb = *sb_ptr;
  float lmax = 0.f;
  float rpart[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = d0 + ty + 16 * i;
    if (r >= D) continue;
    const float iv = inv_std[r], ur = u[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = l0 + tx + 16 * j;
      if (c >= L) continue;
      const float y = __fsub_rn(__fmul_rn(iv, __fmul_rn((float)acc[i][j], sb)),
                                __fmul_rn(ur, csum[c]));
      const float zz = __fmul_rn(iv, y);
      z[(size_t)r * L + c] = zz;
      lmax = fmaxf(lmax, fabsf(zz));
      rpart[j] += __fmul_rn(ur, y);
    }
  }
  // Block max of |z| -> the tile's max.
  for (int off = 16; off > 0; off >>= 1)
    lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
  if ((tid & 31) == 0) wmax[tid >> 5] = lmax;
  // Column sums of u y over the block's rows -> ru.
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx + 16 * j] = rpart[j];
  __syncthreads();
  if (tid == 0) {
    float m = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, wmax[w]);
    atomicMax(&tile_max[d0 / tile_d], __float_as_uint(m));
  }
  if (tid < kBN && l0 + tid < L) {
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red[r][tid];
    atomicAdd(&ru[l0 + tid], s);
  }
}

// out (N, L) += sum over tiles t of the split: sz_t (G0_t^T z8_t).
template <class Rows>
__global__ void __launch_bounds__(kThreads)
q8_left_kernel(Rows g, const float* __restrict__ z,
               const unsigned int* __restrict__ tile_max,
               float* __restrict__ out, int D, int L, int tile_d,
               int tiles_per_split) {
  // Byte k of word row [m] holds SNP row k of the chunk; the odd row
  // stride keeps the column reads of the inner loop off one bank.
  __shared__ int Aw[kBM][kQR / 4 + 1];
  __shared__ int Bw[kBN][kQR / 4 + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int s0 = blockIdx.x * kBM, l0 = blockIdx.y * kBN;
  const int n_tiles = (D + tile_d - 1) / tile_d;
  const int t_lo = blockIdx.z * tiles_per_split;
  const int t_hi = min(n_tiles, t_lo + tiles_per_split);
  const int N = 4 * g.groups;
  const int ak = tid >> 4, aq = tid & 15;  // A loader: row, group
  const int jg = (s0 >> 2) + aq;
  int8_t* A8 = reinterpret_cast<int8_t*>(&Aw[0][0]);
  int8_t* B8 = reinterpret_cast<int8_t*>(&Bw[0][0]);
  constexpr int kRow = 4 * (kQR / 4 + 1);  // bytes per padded word row

  float facc[4][4] = {};
  for (int t = t_lo; t < t_hi; ++t) {
    const int tstart = t * tile_d;
    const int tend = min(D, tstart + tile_d);
    const float sz = __fadd_rn(
        __fmul_rn(__uint_as_float(tile_max[t]), 1.0f / 127.0f), 1e-30f);
    const float inv_sz = 1.0f / sz;
    int iacc[4][4] = {};
    for (int dc = tstart; dc < tend; dc += kQR) {
      const int d = dc + ak;
      uint32_t v = Rows::kMissing;  // dosage 0
      if (d < tend && jg < g.groups) v = g.group(d, jg);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        A8[(aq * 4 + p) * kRow + ak] = (int8_t)Rows::dosage(v, p);
      for (int e = tid; e < kQR * kBN; e += kThreads) {
        const int k = e / kBN, n = e % kBN;
        const int dd = dc + k, l = l0 + n;
        float q = 0.f;
        if (dd < tend && l < L) {
          q = rintf(__fmul_rn(z[(size_t)dd * L + l], inv_sz));
          q = fminf(fmaxf(q, -127.f), 127.f);
        }
        B8[n * kRow + k] = (int8_t)(int)q;
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
        facc[i][j] = __fadd_rn(facc[i][j], __fmul_rn((float)iacc[i][j], sz));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty + 16 * i;
    if (s >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = l0 + tx + 16 * j;
      if (c < L) atomicAdd(&out[(size_t)s * L + c], facc[i][j]);
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

template <class Rows>
int launch_q8_w(Rows g, const void* inv_std, const void* u, const void* bq,
                const void* sb, const void* csum, void* z, void* tile_max,
                void* ru, int D, int L, int tile_d, void* stream) {
  q8_w_kernel<Rows><<<grid_of(D, L), kThreads, 0, (cudaStream_t)stream>>>(
      g, (const float*)inv_std, (const float*)u, (const int8_t*)bq,
      (const float*)sb, (const float*)csum, (float*)z,
      (unsigned int*)tile_max, (float*)ru, D, L, tile_d);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch_q8_left(Rows g, const void* z, const void* tile_max, void* out,
                   int D, int L, int tile_d, int splits, int tiles_per_split,
                   void* stream) {
  q8_left_kernel<Rows><<<grid_of(4 * g.groups, L, splits), kThreads, 0,
                         (cudaStream_t)stream>>>(
      g, (const float*)z, (const unsigned int*)tile_max, (float*)out, D, L,
      tile_d, tiles_per_split);
  return (int)cudaGetLastError();
}

}  // namespace gp
