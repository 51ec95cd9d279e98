// Shared device code of the packed-genotype kernels: the PLINK 2-bit
// decode, the per-SNP standardisation, the register-tiled FMA step and the
// __dp4a tile of the raw integer product G0 bq.
//
// Layout (original sample order, no permutation): genotypes are a
// row-major (D, N4) uint8 matrix; byte j of row d holds samples 4j..4j+3,
// sample 4j+p in bits 2p..2p+1.  PLINK count_A1 codes: 00 -> 2,
// 01 -> missing, 10 -> 1, 11 -> 0.  Column padding bytes are 0x55 (all
// missing) and standardise to 0; rows at or beyond D read as 0.
//
// A = diag(inv_std) (G - mean) with missing entries 0.  In bf16 mode the
// scale, the shift and the standardised value are rounded to bf16 at the
// points the TPU kernels round them (ops/pallas_kernels.py
// _standardize_packed_tile); products of bf16 values are exact in f32 and
// all sums are f32, so an f32 FMA loop over bf16-rounded operands is the
// bf16-operand / f32-accumulate contract of the reference.
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

// Standardised value of one 2-bit code; missing -> 0.  The explicit
// _rn intrinsics keep the multiply and the add as two roundings, as the
// reference computes them (no FMA contraction).
__device__ __forceinline__ float standardize(int c, RowScale s, bool bf16) {
  if (c == 1) return 0.f;
  const float x = __fadd_rn(__fmul_rn((float)((4 - c) >> 1), s.sc), s.sh);
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

constexpr int kQW = 8;  // packed bytes (32 samples) per chunk of q8_right_tile

// acc[i][j] = sum over all samples of G0[d0 + ty + 16 i] . bq[:, l0 + tx + 16 j]:
// the raw integer product G0 bq of one 64 x 64 output tile, on __dp4a
// (the four samples of one packed byte against four rows of bq).  Exact
// in int32 while 2 * 127 * 4 * n4 < 2^31.  Rows >= D and columns >= L
// read as 0.
__device__ __forceinline__ void q8_right_tile(const uint8_t* __restrict__ packed,
                                              const int8_t* __restrict__ bq,
                                              int D, int n4, int L, int d0,
                                              int l0, int acc[4][4]) {
  __shared__ int Aw[kQW][kBM];
  __shared__ int Bw[kQW][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int j0 = 0; j0 < n4; j0 += kQW) {
    for (int e = tid; e < kQW * kBM; e += kThreads) {
      const int k = e % kQW, m = e / kQW;
      const int d = d0 + m, j = j0 + k;
      Aw[k][m] = (d < D && j < n4) ? decode_word(packed[(size_t)d * n4 + j]) : 0;
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

}  // namespace gp
