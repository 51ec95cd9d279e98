// Quantised (q8) steering pass on the packed layout, in two kernels.
//
// The TPU kernel (_gram_q8_packed_kernel) does, per row tile of tile_d
// SNPs: W = G0 . bq (s8 x s8 -> s32), y = s (W sb) - u csum, z = s y,
// z8 = round(z / sz) with ONE sz = max|z| / 127 over the whole tile,
// out += (G0^T z8) sz and ru += sum_d u y.  The scale of a tile needs the
// whole (tile_d, L) block of z before the second product, and blocks here
// run in parallel, so the pass is split where that reduction sits:
//
//   q8_w_kernel    : W, y, z (stored f32), ru, and the per-tile max|z|
//                    (atomicMax on the float bits, all values >= 0);
//   q8_left_kernel : z8 from z and the tile's scale, the integer product
//                    G0^T z8 summed exactly in s32 inside each tile, then
//                    scaled and added in f32 across the tiles of a split,
//                    and across splits with f32 atomics.
//
// The integer products run on __dp4a: four int8 lanes of a word, four
// samples of one packed byte in the first kernel and four SNP rows in the
// second.
#include "packed_common.cuh"

namespace gp {

constexpr int kQR = 16; // SNP rows per chunk of q8_left (4 words)

// z (D, L) f32, ru (L) += sum_d u y, tile_max[d / tile_d] = max |z|.
// tile_d is a multiple of kBM, so a block's rows lie in one tile.
__global__ void __launch_bounds__(kThreads)
q8_w_kernel(const uint8_t* __restrict__ packed,
            const float* __restrict__ inv_std, const float* __restrict__ u,
            const int8_t* __restrict__ bq, const float* __restrict__ sb_ptr,
            const float* __restrict__ csum, float* __restrict__ z,
            unsigned int* __restrict__ tile_max, float* __restrict__ ru,
            int D, int n4, int L, int tile_d) {
  __shared__ float red[16][kBN];
  __shared__ float wmax[kThreads / 32];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d0 = blockIdx.x * kBM, l0 = blockIdx.y * kBN;

  int acc[4][4] = {};
  q8_right_tile(packed, bq, D, n4, L, d0, l0, acc);

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
__global__ void __launch_bounds__(kThreads)
q8_left_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ z,
               const unsigned int* __restrict__ tile_max,
               float* __restrict__ out, int D, int n4, int L, int tile_d,
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
  const int N = 4 * n4;
  const int ak = tid >> 4, aq = tid & 15;  // A loader: row, byte
  const int byte = (s0 >> 2) + aq;
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
      uint32_t v = 0x55;  // all missing -> dosage 0
      if (d < tend && byte < n4) v = packed[(size_t)d * n4 + byte];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        A8[(aq * 4 + p) * kRow + ak] = (int8_t)dosage_of(code_at(v, p));
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

}  // namespace gp

extern "C" {

int gp_q8_w(const void* packed, const void* inv_std, const void* u,
            const void* bq, const void* sb, const void* csum, void* z,
            void* tile_max, void* ru, int D, int n4, int L, int tile_d,
            void* stream) {
  const dim3 grid((D + gp::kBM - 1) / gp::kBM, (L + gp::kBN - 1) / gp::kBN);
  gp::q8_w_kernel<<<grid, gp::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const float*)inv_std, (const float*)u,
      (const int8_t*)bq, (const float*)sb, (const float*)csum, (float*)z,
      (unsigned int*)tile_max, (float*)ru, D, n4, L, tile_d);
  return (int)cudaGetLastError();
}

int gp_q8_left(const void* packed, const void* z, const void* tile_max,
               void* out, int D, int n4, int L, int tile_d, int splits,
               int tiles_per_split, void* stream) {
  const dim3 grid((4 * n4 + gp::kBM - 1) / gp::kBM,
                  (L + gp::kBN - 1) / gp::kBN, splits);
  gp::q8_left_kernel<<<grid, gp::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const float*)z, (const unsigned int*)tile_max,
      (float*)out, D, n4, L, tile_d, tiles_per_split);
  return (int)cudaGetLastError();
}

}  // extern "C"
