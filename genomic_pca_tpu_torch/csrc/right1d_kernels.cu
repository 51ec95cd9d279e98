// The right products A B of the 1-D mode in bf16 mode for a narrow B (the
// loadings A V_k, L = k = 10), both genotype layouts:
// right_narrow_mma_kernel.  It replaces
//
//   fused_right_apply_packed (genomic_pca_tpu/ops/pallas_kernels.py :529,
//        pallas_call :545; body _right_packed_kernel :464) -> gp_right_narrow_packed
//   fused_right_apply        (:181, pallas_call :197; body _right_kernel
//        :112)                                            -> gp_right_narrow_dense
//
// out (D, L) f32 = A (D, N) B (N, L): A the reference's bf16 tile, B
// rounded to bf16 once by the wrapper, sums in f32, out not rounded.  The
// wrapper takes it for L <= 16; wider bf16 calls take right2d_mma_kernel's
// f32 store (right2d_kernels.cu) and f32 mode the FMA loop right_kernel.
//
// Bound on an H100 at 262,144 x 2,048, L = 10: by the genotype bytes (134
// MB packed, 0.04 ms at 3.35 TB/s; 537 MB dense, 0.16 ms), against 2 D N 16
// = 17 GFLOP of MMA (0.02 ms).  So the product is a streaming decode, and
// the SM's issue slots go to the decode and the loads, not to empty
// columns:
//   - wgmma m64n16k16 with A from registers (one n16 tile covers L <= 16;
//     wider B takes one column block of 16 a tile);
//   - every consumer warpgroup decodes its own 64 rows straight into its
//     A fragments, with each row's codes in registers (packed_values, the
//     4 bf16 values of its codes; dense_pairs, its bf16x2 scale and shift):
//     no decoded tile in shared memory and no producer hand-off;
//   - the samples are taken in an order that fits the fragment: a chunk
//     is 128 bytes of each row (512 samples packed, 128 dense), and lane q
//     (= lane % 4) of a row owns its bytes 32q .. 32q + 31; K step m of the
//     chunk gives slots {2q, 2q + 1, 2q + 8, 2q + 9} of lane q to the four
//     samples of its byte m (packed) or word m (dense), chunk samples
//     (chunk / 4) q + 4 m + p, p = 0..3.  B comes
//     in the same order, so a thread decodes whole bytes it loaded and A B
//     is unchanged (the order's statement: right_narrow_operand, ops/kernels.py);
//   - a loader warp's TMA brings each chunk's raw rows (64 rows a
//     warpgroup, with the 128-byte swizzle, so that the 16-byte loads of
//     rows lane / 4 and lane / 4 + 8 by lanes 2q, 2q + 1 fall on distinct
//     banks) and its B (a bulk copy of 512 bytes a K step) into one ring;
//   - A fragments of 4 K steps (one commit group) in two register
//     buffers: a buffer is written again only after wgmma_wait<1> has seen
//     its MMAs complete, so a group decodes while the last one runs, and a
//     slot is released at the next chunk's first wait;
//   - every kFold samples the accumulator is folded into a register total;
//     only the L columns are stored, no atomics;
//   - B is cast and permuted into that order on the card, in the same C
//     call (narrow_operand_kernel, into the caller's workspace);
//   - a persistent grid walks the tiles (256 rows x 16 columns), the ring
//     running on across them; where the tiles are fewer than the SMs (a
//     streamed strip of 2,048 rows has 8) the samples split into
//     fixed-order ranges whose slab sum_splits_kernel adds.
// The plan lives here (right_narrow_plan), reported by
// gp_right_narrow_plan.
#include <algorithm>

#include "hopper.cuh"

namespace gp {

constexpr int kNarrowWGs = 4;                       // consumer warpgroups
constexpr int kNarrowRows = kNarrowWGs * kTileRows;  // rows of a tile
constexpr int kNarrowCols = 16;                     // columns of a tile
constexpr int kNarrowThreads = kNarrowWGs * 128 + 32;  // + the loader warp
constexpr int kChunkBytes = 128;                    // bytes of a row a chunk
constexpr int kStepBytes = 16 * kNarrowCols * 2;    // B of one K step
constexpr int kGroup = 4;                           // K steps a wgmma group

// The ring of one layout: a slot holds a chunk's raw rows (a 64-row box
// per warpgroup, 1024-byte aligned for the swizzle) and its B.
template <class Rows>
struct NarrowSmem {
  static constexpr int kChunkSamples = kChunkBytes * 4 / Rows::kGroupBytes;
  static constexpr int kSteps = kChunkSamples / 16;   // 32 packed, 8 dense
  static constexpr int kBoxBytes = kTileRows * kChunkBytes;
  static constexpr int kBBytes = kSteps * kStepBytes;
  static constexpr int kSlotBytes = kNarrowWGs * kBoxBytes + kBBytes;
  static constexpr int kStages = Rows::kGroupBytes == 1 ? 4 : 6;
  static constexpr int kFoldChunks = kFold / kChunkSamples;
  static_assert(kFold % kChunkSamples == 0, "a fold falls between chunks");
  static_assert(kSlotBytes % 1024 == 0, "slots keep the swizzle's alignment");
  static_assert(kSteps % (2 * kGroup) == 0, "an even number of groups a chunk");
  static constexpr int kBar = kStages * kSlotBytes;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// The launch over D rows, `chunks` chunks of samples and L columns on `sms`
// SMs: tiles of kNarrowRows x kNarrowCols, a persistent grid of at most one
// block an SM; where the tiles are fewer than the SMs, the samples split
// into grid.z ranges of `per` chunks (one tile a block).
struct NarrowPlan {
  dim3 grid;
  int tiles, per;
};

inline NarrowPlan right_narrow_plan(int D, int chunks, int L, int sms) {
  const int tiles = std::max(1, (D + kNarrowRows - 1) / kNarrowRows) *
                    std::max(1, (L + kNarrowCols - 1) / kNarrowCols);
  int splits = 1;
  if (tiles < sms) splits = std::max(1, std::min(sms / tiles, chunks));
  const int per = std::max(1, (chunks + splits - 1) / splits);
  splits = std::max(1, (chunks + per - 1) / per);
  return {dim3(splits > 1 ? tiles : std::min(tiles, sms), 1, splits), tiles, per};
}

// out[z] (D, L) f32 = A B over chunks [z per, (z + 1) per) of `chunks`;
// bop the permuted bf16 B (column block, K step, 16 x 16 K-major core
// matrices: right_narrow_operand), `steps` K steps a column block.
template <class Rows>
__global__ void __launch_bounds__(kNarrowThreads, 1)
right_narrow_mma_kernel(const __grid_constant__ CUtensorMap rows_map,
                        const uint8_t* __restrict__ bop,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv_std, float* __restrict__ out,
                        int D, int chunks, int steps, int L, int per) {
  using Smem = NarrowSmem<Rows>;
  constexpr bool kPacked = Rows::kGroupBytes == 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Ring<Smem::kStages> ring{reinterpret_cast<uint64_t*>(sm + Smem::kBar)};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.z * per;
  const int n_chunks = max(0, min(chunks, c0 + per) - c0);
  const int row_tiles = max(1, (D + kNarrowRows - 1) / kNarrowRows);
  const int all_tiles = row_tiles * ((L + kNarrowCols - 1) / kNarrowCols);
  const int tiles = (all_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const auto origin = [&](int k) {  // (first row, column block) of tile k
    const int t = blockIdx.x + k * gridDim.x;
    return make_int2(t % row_tiles * kNarrowRows, t / row_tiles);
  };
  if (tid == 0) {
    // Fills: the loader's arrival + the bytes; releases: every consumer warp.
    ring.init(1, 4 * kNarrowWGs);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kNarrowWGs) {
    // Loader: lane 0 loads chunk g of the block's walk as soon as its slot
    // is free: a box of 64 rows for each warpgroup, then the chunk's B.
    if (lane == 0)
      for (int g = 0; g < tiles * n_chunks; ++g) {
        const int j = c0 + g % n_chunks;
        const int2 o = origin(g / n_chunks);
        uint8_t* slot = sm + ring.slot(g) * Smem::kSlotBytes;
        ring.wait_empty(g);
        mbar_arrive_expect_tx(ring.full(g), Smem::kSlotBytes);
#pragma unroll
        for (int w = 0; w < kNarrowWGs; ++w)
          tma_load_2d(slot + w * Smem::kBoxBytes, &rows_map, j * kChunkBytes,
                      o.x + kTileRows * w, ring.full(g));
        bulk_load(slot + kNarrowWGs * Smem::kBoxBytes,
                  bop + ((size_t)o.y * steps + (size_t)j * Smem::kSteps) * kStepBytes,
                  Smem::kBBytes, ring.full(g));
      }
    return;
  }

  // Consumers: warp w of warpgroup wg owns rows 16 w + r and 16 w + r + 8
  // of its 64 (r = lane / 4), lane q = lane % 4 their bytes 32q .. 32q + 31.
  const int wg = warp / 4, w = warp % 4, r = lane / 4, q = lane % 4;
  const int box_row = 16 * w + r;
  // The two 16-byte loads of a row: chunks 2q and 2q + 1 of its 128 bytes,
  // where the swizzle put them (row % 8 = r).
  const int off0 = box_row * kChunkBytes + (((2 * q) ^ r) << 4);
  const int off1 = box_row * kChunkBytes + (((2 * q + 1) ^ r) << 4);
  const auto codes_of = [&](int d) {  // the row's codes; 0 past D
    const RowScale s = d < D ? row_scale(mean, inv_std, d, true) : RowScale{0.f, 0.f};
    return kPacked ? packed_values(s) : dense_pairs(s);
  };
  float acc[8], tot[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = tot[i] = 0.f;
  // A fragments of kGroup K steps, in two buffers: group i decodes into
  // buffer i % 2 while the MMAs of group i - 1 run (a chunk has an even
  // number of groups, so the alternation runs on across chunks).
  uint32_t a[2][kGroup][4] = {};
  int pending = -1;  // the chunk whose slot awaits its MMAs' completion
  for (int k = 0; k < tiles; ++k) {
    const int2 o = origin(k);
    const int d0 = o.x + kTileRows * wg + box_row;
    const uint2 v0 = codes_of(d0), v1 = codes_of(d0 + 8);
    for (int c = 0; c < n_chunks; ++c) {
      const int g = n_chunks * k + c;
      ring.wait_full(g);
      const uint8_t* slot = sm + ring.slot(g) * Smem::kSlotBytes;
      const uint8_t* box = slot + wg * Smem::kBoxBytes;
      const uint4 x0 = *reinterpret_cast<const uint4*>(box + off0);
      const uint4 y0 = *reinterpret_cast<const uint4*>(box + off1);
      const uint4 x1 = *reinterpret_cast<const uint4*>(box + off0 + 8 * kChunkBytes);
      const uint4 y1 = *reinterpret_cast<const uint4*>(box + off1 + 8 * kChunkBytes);
      const uint32_t raw0[8] = {x0.x, x0.y, x0.z, x0.w, y0.x, y0.y, y0.z, y0.w};
      const uint32_t raw1[8] = {x1.x, x1.y, x1.z, x1.w, y1.x, y1.y, y1.z, y1.w};
      const uint32_t bt = smem_u32(slot + kNarrowWGs * Smem::kBoxBytes);
      const bool first = c % Smem::kFoldChunks == 0;
      if (first && c > 0) {
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) tot[i] += acc[i];
      }
#pragma unroll
      for (int m0 = 0; m0 < Smem::kSteps; m0 += kGroup) {
        uint32_t(&f)[kGroup][4] = a[(m0 / kGroup) & 1];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int m = m0 + i;
          uint2 u0, u1;
          if constexpr (kPacked) {  // byte m % 4 of word m / 4
            u0 = packed_byte((raw0[m / 4] >> (8 * (m % 4))) & 0xFFu, v0);
            u1 = packed_byte((raw1[m / 4] >> (8 * (m % 4))) & 0xFFu, v1);
          } else {
            u0 = dense_word(raw0[m], v0);
            u1 = dense_word(raw1[m], v1);
          }
          f[i][0] = u0.x;
          f[i][1] = u1.x;
          f[i][2] = u0.y;
          f[i][3] = u1.y;
        }
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          wgmma_m64n16k16_rs(acc, f[i], desc_plain(bt + (m0 + i) * kStepBytes, 128, 256),
                             first && m0 + i == 0 ? 0 : 1);
        wgmma_commit();
        // The last group's MMAs have completed: its buffer may be written
        // again, and the slot of the chunk they read released.
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < kGroup; ++i) fence_regs(a[((m0 / kGroup) & 1) ^ 1][i]);
        if (m0 == 0 && pending >= 0) {
          __syncwarp();
          if (lane == 0) ring.release(pending);
          pending = -1;
        }
      }
      // The chunk's raw rows were read into registers at its start; its B
      // is free once its last MMAs complete (the next chunk's first wait).
      pending = g;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (pending >= 0) {
      __syncwarp();
      if (lane == 0) ring.release(pending);
      pending = -1;
    }
    // Rows d0 and d0 + 8, columns 16 o.y + 8 j + 2 q + e.
    float* dst = out + (size_t)blockIdx.z * D * L;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = d0 + 8 * h, col = kNarrowCols * o.y + 8 * j + 2 * q + e;
          const int i = 4 * j + 2 * h + e;
          if (row < D && col < L) dst[(size_t)row * L + col] = n_chunks ? tot[i] + acc[i] : 0.f;
          tot[i] = 0.f;
        }
  }
}

// bop (column blocks, K steps, 256) bf16 from b (N, L) f32: the operand
// order of right_narrow_operand (ops/kernels.py, which states it and which
// the tests hold this to), each value rounded once to nearest even, zeros
// past N and L.  One thread an element.
__global__ void __launch_bounds__(kThreads)
narrow_operand_kernel(const float* __restrict__ b, __nv_bfloat16* __restrict__ bop,
                      int N, int L, int chunk, int steps, int blocks) {
  const size_t total = (size_t)blocks * steps * 256;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int e = (int)(i % 256), step = (int)(i / 256 % steps);
    const int c = (int)(i / 256 / steps);
    // e = 128 nh + 64 kh + 8 n8 + kl, slot kl = 2 q + pl, sample p = 2 kh + pl.
    const int nh = e >> 7, kh = (e >> 6) & 1, n8 = (e >> 3) & 7, kl = e & 7;
    const int per = chunk / 16;
    const int sample = step / per * chunk + chunk / 4 * (kl >> 1) + 4 * (step % per) +
                       2 * kh + (kl & 1);
    const int col = 16 * c + 8 * nh + n8;
    bop[i] = __float2bfloat16_rn(sample < N && col < L ? b[(size_t)sample * L + col] : 0.f);
  }
}

// The raw rows (D, row bytes) in boxes of one chunk's 128 bytes x 64 rows
// with the 128-byte swizzle.
template <class Rows>
int narrow_rows_map(CUtensorMap* map, Rows g, int D) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.p,
                    g.groups * Rows::kGroupBytes, D, kChunkBytes, kTileRows,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The workspace of a launch: bop (bf16, column blocks x K steps x 256),
// then the slab (splits, D, L) f32 when the plan splits the samples.
inline size_t narrow_operand_bytes(int chunks, int chunk_samples, int L) {
  return (size_t)std::max(1, (L + kNarrowCols - 1) / kNarrowCols) * chunks *
         (chunk_samples / 16) * kStepBytes;
}

// out (D, L) f32 = A B, b (N, L) f32; `work` as gp_right_narrow_plan
// sizes it.  Two launches on the stream: the operand, then the product
// (and the slab's sum where the samples split).
template <class Rows>
int launch_right_narrow(Rows g, const void* mean, const void* inv_std,
                        const void* b, float* out, void* work, int D, int N,
                        int L, int sms, void* stream) {
  using Smem = NarrowSmem<Rows>;
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (g.groups * Rows::kGroupBytes + kChunkBytes - 1) / kChunkBytes;
  const NarrowPlan p = right_narrow_plan(D, chunks, L, sms);
  const int splits = (int)p.grid.z;
  if (D <= 0 || L <= 0) return 0;
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  const size_t op_bytes = narrow_operand_bytes(chunks, Smem::kChunkSamples, L);
  const int steps = chunks * Smem::kSteps, blocks = (L + kNarrowCols - 1) / kNarrowCols;
  uint8_t* bop = static_cast<uint8_t*>(work);
  float* slab = reinterpret_cast<float*>(bop + op_bytes);
  const size_t elems = op_bytes / 2;
  narrow_operand_kernel<<<(int)std::max<size_t>(1, std::min<size_t>(
                              (elems + kThreads - 1) / kThreads, 4 * sms)),
                          kThreads, 0, st>>>(
      (const float*)b, reinterpret_cast<__nv_bfloat16*>(bop), N, L,
      Smem::kChunkSamples, steps, blocks);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  rc = narrow_rows_map(&map, g, D);
  if (rc != 0) return rc;
  static OncePerDevice once;
  rc = allow_smem(once, right_narrow_mma_kernel<Rows>, Smem::kBytes);
  if (rc != 0) return rc;
  right_narrow_mma_kernel<Rows><<<p.grid, kNarrowThreads, Smem::kBytes, st>>>(
      map, bop, (const float*)mean, (const float*)inv_std, splits > 1 ? slab : out,
      D, chunks, steps, L, p.per);
  rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  return launch_sum_splits(static_cast<const float*>(slab), out, D, L, L, splits,
                           sms, st);
}

}  // namespace gp

extern "C" {

// out (D, L) f32 = A B over packed rows of n4 bytes (a multiple of 16,
// 16-byte aligned), b (N, L) f32; `work` as gp_right_narrow_plan sizes it.
int gp_right_narrow_packed(const void* packed, const void* mean, const void* inv_std,
                           const void* b, void* out, void* work, int D, int n4,
                           int N, int L, int sms, void* stream) {
  return gp::launch_right_narrow(gp::PackedRows{(const uint8_t*)packed, n4}, mean,
                                 inv_std, b, (float*)out, work, D, N, L, sms, stream);
}

// The same over dense rows of n4 words.
int gp_right_narrow_dense(const void* geno, const void* mean, const void* inv_std,
                          const void* b, void* out, void* work, int D, int n4,
                          int N, int L, int sms, void* stream) {
  return gp::launch_right_narrow(gp::DenseRows{(const int8_t*)geno, n4}, mean,
                                 inv_std, b, (float*)out, work, D, N, L, sms, stream);
}

// The plan of the narrow right product over D rows of `row_bytes` bytes
// (group_bytes 1 packed, 4 dense) and L columns on `sms` SMs, as
// launch_right_narrow launches it, into plan[0..6]: the tile (rows,
// columns), the grid's blocks (x), the sample ranges (grid z), the
// samples of a chunk, the workspace's bytes (the operand, then the slab
// where the samples split).
int gp_right_narrow_plan(int D, int row_bytes, int group_bytes, int L, int sms,
                         long long* plan) {
  const int chunks = (row_bytes + gp::kChunkBytes - 1) / gp::kChunkBytes;
  const int chunk_samples = gp::kChunkBytes * 4 / group_bytes;
  const gp::NarrowPlan p = gp::right_narrow_plan(D, chunks, L, sms);
  plan[0] = gp::kNarrowRows;
  plan[1] = gp::kNarrowCols;
  plan[2] = p.grid.x;
  plan[3] = p.grid.z;
  plan[4] = chunk_samples;
  plan[5] = (long long)gp::narrow_operand_bytes(chunks, chunk_samples, L) +
            (p.grid.z > 1 ? (long long)p.grid.z * D * L * 4 : 0);
  return 0;
}

}  // extern "C"
