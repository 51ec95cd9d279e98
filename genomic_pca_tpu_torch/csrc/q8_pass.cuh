// The quantized (q8) power pass in one C call: the entries gp_q8_pass_packed
// / gp_q8_pass_dense (q8_kernels.cu) of kernels 1 and 9, which the 2-D q8
// pass (kernels 7 / 7i and 8 / 8i, `q8_power_pass_2d`) takes too, and their
// plan gp_q8_pass_plan.
//
// The TPU kernels (fused_gram_q8_packed, pallas_kernels.py :977, body
// _gram_q8_packed_kernel :950; fused_gram_q8 :847, body _gram_q8_kernel
// :807) carry (N, L) and (1, L) accumulators through a sequential grid of
// row tiles, computing per tile W = G0 bq (s8 x s8 -> s32), y = s (W sb) -
// u csum, z = s y, one scale sz = max|z| / 127 + 1e-30 over the whole
// (tile_d, L) tile, z8 = clamp(round(z / sz)), then out += (G0^T z8) sz and
// ru += sum u y.  A tile's scale needs its whole z before the second
// product, and Hopper blocks run in parallel, so the pass is three steps on
// the caller's stream, with W in device memory once:
//   1. W = G0 bq, q8_right2d_mma_kernel (q8_right2d_kernels.cu:
//      gp_q8_right2d*), exact in int32 and stored as f32, converted once
//      (exact while 2 * 127 * N < 2^24, and the plain version rounds the
//      same way past it); bq^T built first by transpose_z8_kernel
//      (gp_transpose_i8, zero past N), the operand q8_operand states.
//      Where the row blocks are fewer than the SMs (a streamed strip) the
//      samples split into int32 slabs summed in order.
//   2. The requantization, below: y, z, each tile's max|z|, sz, z8 written
//      straight into z8^T (the left product's operand, zero in every pad
//      entry), and ru.  Each multiply and subtract rounds on its own
//      (__fmul_rn, __fsub_rn: no contraction into an FMA), the reciprocal
//      of sz is one IEEE division a tile, and rintf rounds half to even, as
//      the plain version (`q8_requant_plain`) computes them: the same z8
//      and sz bits.
//   3. sum_t sz[t] G0_t^T z8_t, q8_left2d_mma_kernel (q8_left2d_kernels.cu:
//      gp_q8_left2d_t*) over that z8^T: int32 per row tile folded into f32
//      in tile order; rows split into ranges of whole tiles where the
//      sample blocks are few (8 at 2,048 samples), the slab summed in order.
// No atomics: the same bits every call, and `out` equals the plain version
// at the plan's row ranges bit for bit; ru's order (row blocks of 64, then
// a fixed tree) is the card's own, held to the plain sum by a tolerance.
//
// The requantization reads W twice (once for the tile maxima, once for z8)
// and writes z8^T: at 262,144 x 128 that is 256 MiB read and 32 MiB
// written, about 0.09 ms at 3.35 TB/s.  Its work is split into blocks of 64
// rows x 128 columns whatever the tile, so that a strip of 2,048 rows still
// has 32 blocks (a block per tile would give it 2); the tile's maximum is
// then the max over its blocks' maxima, exact in any order.
//
// One workspace from the caller (gp_q8_pass_plan's bytes) holds bq^T, z8^T,
// sz, the blocks' maxima and ru partials, then a region that holds W and
// the right product's slab, and later the left product's slab (W is dead
// once step 2 ends).  Each .cu compiles in its own nvcc process; these calls
// cross into q8_right2d_kernels.cu and q8_left2d_kernels.cu through their C
// entries.
#pragma once

#include <stddef.h>

#include "packed_common.cuh"

extern "C" {
int gp_q8_right2d_plan(int D, int N, int L, int sms, int* plan);
int gp_q8_left2d_plan(int D, int N, int L, int tile_d, int sms, long long* plan);
int gp_q8_right2d(const void*, const void*, void*, void*, int, int, int, int, int, void*);
int gp_q8_right2d_dense(const void*, const void*, void*, void*, int, int, int, int, int,
                        void*);
int gp_q8_left2d_t(const void*, const void*, const void*, void*, void*, int, int, int, int,
                   int, void*);
int gp_q8_left2d_t_dense(const void*, const void*, const void*, void*, void*, int, int, int,
                         int, int, void*);
int gp_transpose_i8(const void*, void*, int, int, int, int, void*);
}

namespace gp {

typedef int (*Q8RightEntry)(const void*, const void*, void*, void*, int, int, int, int, int,
                            void*);
typedef int (*Q8LeftEntry)(const void*, const void*, const void*, void*, void*, int, int,
                           int, int, int, void*);

constexpr int kReqRows = 64;      // rows of a requantization block (tile_d divides by it)
constexpr int kReqCols = 128;     // columns of a block: 4 a lane
constexpr int kReqThreads = 256;  // 8 warps, 8 rows each
constexpr int kReqWarps = kReqThreads / 32, kReqWarpRows = kReqRows / kReqWarps;
constexpr int kReqLaneCols = kReqCols / 32;

// y = s (w sb) - u c and z = s y, each operation rounded on its own.
__device__ __forceinline__ void q8_yz(float w, float s, float u, float sb, float c,
                                      float& y, float& z) {
  y = __fsub_rn(__fmul_rn(s, __fmul_rn(w, sb)), __fmul_rn(u, c));
  z = __fmul_rn(s, y);
}

// The y and z of a lane's entries of block (rb, cb), rows 64 rb .. and
// columns 128 cb .. of W: lane x of warp wy takes columns 128 cb + x + 32 j
// of rows 64 rb + 8 wy + i (a warp reads 128 bytes a load).  Every load is
// issued before any arithmetic; an entry past D or L reads as w = s = u =
// c = 0, so its y and z are 0.
struct ReqEntries {
  float y[kReqWarpRows][kReqLaneCols], z[kReqWarpRows][kReqLaneCols];
  float u[kReqWarpRows];
};

__device__ __forceinline__ void q8_block_yz(ReqEntries& e, const float* __restrict__ w,
                                            const float* __restrict__ inv_std,
                                            const float* __restrict__ u,
                                            const float* __restrict__ sb,
                                            const float* __restrict__ csum, int D, int L) {
  const int x = threadIdx.x % 32, wy = threadIdx.x / 32;
  const int d0 = blockIdx.x * kReqRows + kReqWarpRows * wy, l0 = blockIdx.y * kReqCols + x;
  float v[kReqWarpRows][kReqLaneCols], s[kReqWarpRows], c[kReqLaneCols];
#pragma unroll
  for (int j = 0; j < kReqLaneCols; ++j) c[j] = l0 + 32 * j < L ? csum[l0 + 32 * j] : 0.f;
#pragma unroll
  for (int i = 0; i < kReqWarpRows; ++i) {
    const bool row = d0 + i < D;
    s[i] = row ? inv_std[d0 + i] : 0.f;
    e.u[i] = row ? u[d0 + i] : 0.f;
#pragma unroll
    for (int j = 0; j < kReqLaneCols; ++j)
      v[i][j] = row && l0 + 32 * j < L ? w[(size_t)(d0 + i) * L + l0 + 32 * j] : 0.f;
  }
  const float b = *sb;
#pragma unroll
  for (int i = 0; i < kReqWarpRows; ++i)
#pragma unroll
    for (int j = 0; j < kReqLaneCols; ++j) q8_yz(v[i][j], s[i], e.u[i], b, c[j], e.y[i][j], e.z[i][j]);
}

// Block (rb, cb) of W as q8_block_yz takes it: maxp[rb][cb] = max|z| over
// its entries (0 if none is real); rup[rb][l] = sum u y over its rows, each
// warp's 8 rows in order, then the warps in order.
__global__ void __launch_bounds__(kReqThreads)
q8_requant_max_kernel(const float* __restrict__ w, const float* __restrict__ inv_std,
                      const float* __restrict__ u, const float* __restrict__ sb,
                      const float* __restrict__ csum, float* __restrict__ maxp,
                      float* __restrict__ rup, int D, int L) {
  __shared__ float sm[kReqWarps], sr[kReqWarps][kReqCols];
  const int x = threadIdx.x % 32, wy = threadIdx.x / 32;
  const int l0 = blockIdx.y * kReqCols + x;
  ReqEntries e;
  q8_block_yz(e, w, inv_std, u, sb, csum, D, L);
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kReqLaneCols; ++j) {
    float r = 0.f;
#pragma unroll
    for (int i = 0; i < kReqWarpRows; ++i) {
      m = fmaxf(m, fabsf(e.z[i][j]));
      r = __fadd_rn(r, __fmul_rn(e.u[i], e.y[i][j]));
    }
    sr[wy][x + 32 * j] = r;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (x == 0) sm[wy] = m;
  __syncthreads();
  if (wy != 0) return;
#pragma unroll
  for (int j = 0; j < kReqLaneCols; ++j) {
    float t = sr[0][x + 32 * j];
#pragma unroll
    for (int k = 1; k < kReqWarps; ++k) t = __fadd_rn(t, sr[k][x + 32 * j]);
    if (l0 + 32 * j < L) rup[(size_t)blockIdx.x * L + l0 + 32 * j] = t;
  }
  m = x < kReqWarps ? sm[x] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (x == 0) maxp[blockIdx.x * gridDim.y + blockIdx.y] = m;
}

// Block (rb, cb): columns 64 rb .. and rows 128 cb .. of z8^T (lp, dp)
// int8, zero past D or L, from block (rb, cb) of W as q8_block_yz takes it
// (z past D or L is 0, so its z8 is 0).  The tile t of the block's rows
// takes m = the max of its blocks' maxima (maxp, `cols` blocks a row
// block), sz = m (1/127) + 1e-30 and z8 = clamp(rint(z (1 / sz)), -127,
// 127); the first block of a tile writes sz[t].  The 64 x 128 bytes turn
// over in shared memory, so that each row of z8^T is written in whole
// words.
__global__ void __launch_bounds__(kReqThreads)
q8_requant_store_kernel(const float* __restrict__ w, const float* __restrict__ inv_std,
                        const float* __restrict__ u, const float* __restrict__ sb,
                        const float* __restrict__ csum, const float* __restrict__ maxp,
                        int8_t* __restrict__ z8t, float* __restrict__ sz, int D, int L,
                        int tile_d, int cols, int dp, int lp) {
  __shared__ uint32_t tile[kReqCols][kReqRows / 4 + 1];  // tile[l][d / 4], bytes of d
  __shared__ float scale;
  uint8_t* tb = reinterpret_cast<uint8_t*>(&tile[0][0]);
  const int x = threadIdx.x % 32, wy = threadIdx.x / 32;
  const int rb = blockIdx.x, per = tile_d / kReqRows;
  const int t = rb / per, first = t * per;
  if (wy == 0) {
    const int n = min((D + kReqRows - 1) / kReqRows - first, per) * cols;
    float m = 0.f;
    for (int k = x; k < n; k += 32) m = fmaxf(m, maxp[(size_t)first * cols + k]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (x == 0) {
      const float s = __fadd_rn(__fmul_rn(m, 1.0f / 127.0f), 1e-30f);
      scale = __fdiv_rn(1.0f, s);
      if (rb == first && blockIdx.y == 0) sz[t] = s;
    }
  }
  ReqEntries e;
  q8_block_yz(e, w, inv_std, u, sb, csum, D, L);
  __syncthreads();
  const float rcp = scale;
#pragma unroll
  for (int i = 0; i < kReqWarpRows; ++i)
#pragma unroll
    for (int j = 0; j < kReqLaneCols; ++j) {
      const float q = fminf(fmaxf(rintf(__fmul_rn(e.z[i][j], rcp)), -127.f), 127.f);
      tb[(x + 32 * j) * (kReqRows + 4) + kReqWarpRows * wy + i] = (uint8_t)(int8_t)q;
    }
  __syncthreads();
  for (int k = threadIdx.x; k < kReqCols * kReqRows / 4; k += kReqThreads) {
    const int lr = k / (kReqRows / 4), wc = k % (kReqRows / 4);
    const int lo = blockIdx.y * kReqCols + lr, d = rb * kReqRows + 4 * wc;
    if (lo < lp && d < dp)
      *reinterpret_cast<uint32_t*>(z8t + (size_t)lo * dp + d) = tile[lr][wc];
  }
}

// ru[l] = the sum of rup[0..rows)[l]: thread (x, y) of block cb adds its
// 32nd of the rows in order, then row y = 0 adds the 32 partials in order.
__global__ void __launch_bounds__(1024)
q8_ru_sum_kernel(const float* __restrict__ rup, float* __restrict__ ru, int rows, int L) {
  __shared__ float part[32][33];
  const int x = threadIdx.x, y = threadIdx.y, l = blockIdx.x * 32 + x;
  const int per = (rows + 31) / 32, hi = min(rows, (y + 1) * per);
  float s = 0.f;
  if (l < L) {
#pragma unroll 8
    for (int r = y * per; r < hi; ++r) s = __fadd_rn(s, rup[(size_t)r * L + l]);
  }
  part[y][x] = s;
  __syncthreads();
  if (y != 0 || l >= L) return;
  for (int k = 1; k < 32; ++k) s = __fadd_rn(s, part[k][x]);
  ru[l] = s;
}

inline size_t align256(size_t x) { return (x + 255) / 256 * 256; }
inline int pad16i(int x) { return (x + 15) / 16 * 16; }

// The plans of both products (as gp_q8_right2d_plan / gp_q8_left2d_plan
// report them) and the workspace's layout (byte offsets, each 256-aligned).
struct Q8PassPlan {
  int right[5];
  long long left[7];
  int ldq, dp, lp, row_blocks, cols;
  size_t bqt, z8t, sz, maxp, rup, region, slab_r, bytes;
};

inline Q8PassPlan q8_pass_plan(int D, int n4, int L, int tile_d, int sms) {
  Q8PassPlan p;
  const int N = 4 * n4;
  gp_q8_right2d_plan(D, N, L, sms, p.right);
  gp_q8_left2d_plan(D, N, L, tile_d, sms, p.left);
  p.ldq = pad16i(N);
  p.dp = pad16i(D);
  p.lp = pad16i(L);
  p.row_blocks = (D + kReqRows - 1) / kReqRows;
  p.cols = (L + kReqCols - 1) / kReqCols;
  const int tiles = tile_d > 0 ? (D + tile_d - 1) / tile_d : 0;
  size_t off = 0;
  p.bqt = off;
  off += align256((size_t)p.lp * p.ldq);
  p.z8t = off;
  off += align256((size_t)p.lp * p.dp);
  p.sz = off;
  off += align256(4 * (size_t)tiles);
  p.maxp = off;
  off += align256(4 * (size_t)p.row_blocks * p.cols);
  p.rup = off;
  off += align256(4 * (size_t)p.row_blocks * L);
  p.region = off;
  p.slab_r = align256(4 * (size_t)D * L);
  const size_t right = p.slab_r + (p.right[4] > 1 ? 4 * (size_t)p.right[4] * D * L : 0);
  const size_t left = p.left[4] > 1 ? 4 * (size_t)p.left[4] * N * L : 0;
  p.bytes = off + (right > left ? right : left);
  return p;
}

// out (4 n4, L) f32, ru (L) f32 of one q8 pass over D rows of n4 groups
// (the right entry's and left entry's layout) with bq (nb, L) int8 (nb <=
// 4 n4 samples; samples past nb meet zeros), inv_std, u (D) f32, sb (1),
// csum (L) f32; `work` of the plan's bytes, 256-byte aligned; tile_d a
// positive multiple of kReqRows.
inline int launch_q8_pass(Q8RightEntry right, Q8LeftEntry left, const void* geno,
                          const void* inv_std, const void* u, const void* bq,
                          const void* sb, const void* csum, void* out, void* ru,
                          void* work, int D, int n4, int nb, int L, int tile_d, int sms,
                          void* stream) {
  if (tile_d <= 0 || tile_d % kReqRows || nb > 4 * n4) return (int)cudaErrorInvalidValue;
  if (D <= 0 || L <= 0 || n4 <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Q8PassPlan p = q8_pass_plan(D, n4, L, tile_d, sms);
  char* base = static_cast<char*>(work);
  int8_t* bqt = reinterpret_cast<int8_t*>(base + p.bqt);
  int8_t* z8t = reinterpret_cast<int8_t*>(base + p.z8t);
  float* sz = reinterpret_cast<float*>(base + p.sz);
  float* maxp = reinterpret_cast<float*>(base + p.maxp);
  float* rup = reinterpret_cast<float*>(base + p.rup);
  float* w = reinterpret_cast<float*>(base + p.region);
  void* slab_r = p.right[4] > 1 ? base + p.region + p.slab_r : nullptr;
  void* slab_l = p.left[4] > 1 ? base + p.region : nullptr;
  int rc = gp_transpose_i8(bq, bqt, nb, L, p.ldq, p.lp, stream);
  if (rc == 0) rc = right(geno, bqt, w, slab_r, D, n4, L, p.ldq, sms, stream);
  if (rc != 0) return rc;
  const float* iv = static_cast<const float*>(inv_std);
  const float* uu = static_cast<const float*>(u);
  const float* b = static_cast<const float*>(sb);
  const float* c = static_cast<const float*>(csum);
  q8_requant_max_kernel<<<dim3(p.row_blocks, p.cols), kReqThreads, 0, st>>>(
      w, iv, uu, b, c, maxp, rup, D, L);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  q8_requant_store_kernel<<<dim3(p.row_blocks, (p.lp + kReqCols - 1) / kReqCols),
                            kReqThreads, 0, st>>>(w, iv, uu, b, c, maxp, z8t, sz, D, L,
                                                  tile_d, p.cols, p.dp, p.lp);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  q8_ru_sum_kernel<<<(L + 31) / 32, dim3(32, 32), 0, st>>>(rup, static_cast<float*>(ru),
                                                   p.row_blocks, L);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return left(geno, z8t, sz, out, slab_l, D, n4, L, tile_d, sms, stream);
}

}  // namespace gp
