// Wide-sample (2-D mode) kernels: the left products A^T W, for both
// genotype layouts.
//
// They replace the 2-D tiled TPU kernels of genomic_pca_tpu/ops/
// pallas_kernels.py, which the JAX container picks once no full-width
// row tile fits VMEM (n_pad >= 11,264 packed samples, 11,136 dense):
//
//   fused_left_apply_2d_packed (:723, pallas_call :741; body
//                        _left2d_packed_kernel :657) -> gp_left2d_packed
//   fused_left_apply_2d        (:346, pallas_call :363; body
//                        _left2d_kernel :278)        -> gp_left2d_dense
//
// The mode's right products are in their own sources: A B is
// right2d_mma_kernel of right2d_kernels.cu in bf16 mode (gp_right2d_packed
// / gp_right2d_dense) and right_kernel of packed_common.cuh unrounded in
// f32 mode (gp_right_packed / gp_right_dense); G0 bq is
// q8_right2d_mma_kernel of q8_right2d_kernels.cu (gp_q8_right2d /
// gp_q8_right2d_dense); sum_t sz_t G0_t^T z8_t is q8_left2d_mma_kernel of
// q8_left2d_kernels.cu (gp_q8_left2d / gp_q8_left2d_dense).
//
// Each kernel is a template over the genotype layout (PackedRows,
// DenseRows of packed_common.cuh), as the 1-D main loops are: a packed
// byte and an aligned dense 32-bit word both hold a group of four samples,
// so the loaders read one group per thread and the loops are the same.
//
// The left products A^T W (kernels 6 and 14), bf16 mode: left2d_mma_kernel.
// On an H100 at 65,536 x 16,384 x 128 the packed one is bound by the bf16
// tensor-core rate (2 D N L = 2.75e11 operations: 0.278 ms against 0.077 ms
// for its 256 MiB of bytes), the dense one by its 1 GiB of int8 (0.333 ms).
// So both products run on the tensor cores, and the genotypes never pass
// through device memory as bf16:
//   - one block per 128 samples x 128 columns of the output, looping over
//     every row in chunks of 64 (no atomics, a fixed sum order: the same
//     inputs give the same bits); where those blocks are fewer than the
//     SMs (the 1-D gram pass at 2,048 samples: 16 for 132) the rows split
//     into ranges of whole folds, each a partial slab that
//     sum_splits_kernel adds in a fixed order (left2d_plan);
//   - one loader warp issues every TMA load as soon as its slot is free:
//     each chunk's raw genotype rows and moments, and its W tile (bf16,
//     rounded once by the wrapper; 128-byte swizzled), into shared-memory
//     rings;
//   - a producer warpgroup decodes the raw rows straight into the bf16 A
//     tile of a third ring (decode_rows of hopper.cuh: a per-row table of
//     nibble pairs packed, bf16x2 arithmetic dense), each warp a whole
//     chunk, so that four chunks are in flight;
//   - two consumer warpgroups, one per 64 samples, issue wgmma m64n128k16
//     with both operands MN-major from the swizzled tiles; mbarriers hand
//     every slot over and back, and setmaxnreg gives the consumers the
//     registers the loader's warpgroup does not need;
//   - every kFold rows the accumulator is folded into a register total,
//     so that f32 rounding grows with D / kFold + kFold terms, not with D
//     (a million rows at biobank scale), whatever the tensor core's
//     internal accumulation.
// What holds it above its bound (PERF.md): the decode of each chunk, and
// the shared-memory traffic of its operands (48 KB of wgmma reads, both
// consumer warpgroups reading the whole W tile), take longer than the
// chunk's MMAs.  The W stream from L2 (D L 2 bytes a block) costs little,
// so the grid is a plain one of 128-sample blocks.
// f32 mode ("HIGHEST" in the reference) keeps the f32 FMA loop
// left2d_kernel: a dispatch on the precision, not a fallback.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError() so that a refused launch is never silent.
#include "hopper.cuh"

namespace gp {

// out (N, L) = A^T (N, D) . W (D, L) in f32, N = 4 * groups; one block per
// 64 x 64 output tile, looping over every row.  The sum over D runs in
// partials of kFold rows added into a running total.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
left2d_kernel(Rows g, const float* __restrict__ mean,
              const float* __restrict__ inv_std, const float* __restrict__ w,
              float* __restrict__ out, int D, int L) {
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
    if (dc % kFold == 0) {
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
      const RowScale rs = row_scale(mean, inv_std, d, false);
      const uint32_t v = g.group(d, jg);
#pragma unroll
      for (int p = 0; p < 4; ++p) x[p] = standardized<Rows>(v, p, rs, false);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) As[ak][aq * 4 + p] = x[p];
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      const int dd = dc + k, l = l0 + n;
      Bs[k][n] = (dd < D && l < L) ? w[(size_t)dd * L + l] : 0.f;
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

// --- left2d_mma_kernel: the tensor-core left product (bf16 mode) ----------

// The rings.  The loader runs as far ahead as their depths allow: chunk j's
// raw rows (and moments) go out with the W tile of chunk j - (kRawStages -
// kWStages); a producer warp decodes a raw slot into an A slot of a ring of
// kAStages, deep enough for the four chunks the producer warps decode at
// once and the two the consumers hold.  The packed rows are small (2 KB a
// chunk), so that ring is deep; the dense ones take 8 KB.  The depths fill
// most of the 227 KB a block may have (8 A slots, or 3 W slots dense, ran
// slower).
static_assert(kFold % kTileRows == 0, "a fold falls between chunks");
constexpr int kLeftFoldChunks = kFold / kTileRows;

// Ring depths and the shared-memory layout (byte offsets from a 1024-byte
// aligned base).  A raw slot: 64 rows of the tile's groups, then 64 means
// and 64 inv_stds.
template <class Rows>
struct LeftMmaSmem {
  static constexpr bool kPacked = Rows::kGroupBytes == 1;
  static constexpr int kAStages = 6;                // decoded A tiles
  static constexpr int kWStages = kPacked ? 5 : 4;  // W tiles
  static constexpr int kRawStages = kPacked ? 11 : 7;
  static_assert(kRawStages >= kWStages, "the loader's raw lead");
  // A producer waits for its A slot by parity alone, which is safe only
  // while chunk it - 2 kAStages has been released.  The loader's W waits
  // guarantee it: raw(it) goes out after the release of chunk it - 1 -
  // kRawStages.
  static_assert(kRawStages <= 2 * kAStages - 1, "the A ring's parity order");
  static constexpr int kRowBytes = 32 * Rows::kGroupBytes;  // a raw tile row
  static constexpr int kRawBytes = kTileRows * kRowBytes;
  static constexpr int kRawSlot = kRawBytes + 2 * kTileRows * 4;
  static constexpr int kA = 0;
  static constexpr int kW = kA + kAStages * kTileBytes;
  static constexpr int kRaw = kW + kWStages * kTileBytes;
  static constexpr int kTbl = kRaw + kRawStages * kRawSlot;  // a table a warp
  static constexpr int kBar = kTbl + kProducerWarps * kWarpRows * 16 * 4;
  static constexpr int kBytes =
      kBar + 2 * (kAStages + kWStages + kRawStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// The tensor maps of one launch (boxes past the matrix arrive as zeros):
// W (D, ldw) bf16 in 64 x 64 boxes with the 128-byte swizzle; the genotype
// rows (D, row bytes) in boxes of one tile's groups x 64 rows; mean and
// inv_std (D) f32 in boxes of 64.
struct LeftMmaMaps {
  CUtensorMap w, rows, mean, inv_std;
};

// out[z] (N, L) = A^T W over the chunks [z per, (z + 1) per) of the rows,
// z = blockIdx.z, N = 4 * groups, with A in the reference's bf16 rounding
// and W bf16 (columns >= L zero); sums in f32.  out is the result when
// there is one range, else the slab of partials.  `per` is a whole number
// of folds, so a range's folds are the unsplit kernel's.
template <class Rows>
__global__ void __launch_bounds__(kMmaThreads, 1)
left2d_mma_kernel(const __grid_constant__ LeftMmaMaps maps, int groups,
                  float* __restrict__ out, int D, int L, int per) {
  using Smem = LeftMmaSmem<Rows>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Smem::kBar);
  const Ring<Smem::kAStages> a{bars};
  const Ring<Smem::kWStages> wr{bars + 2 * Smem::kAStages};
  const Ring<Smem::kRawStages> raw{bars + 2 * (Smem::kAStages + Smem::kWStages)};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = blockIdx.x * kTileSamples, l0 = blockIdx.y * kMmaCols;
  const int c0 = blockIdx.z * per;
  const int chunks = max(0, min((D + kTileRows - 1) / kTileRows, c0 + per) - c0);
  if (tid == 0) {
    a.init(1, 2);    // the producer warp of the chunk; both consumer warpgroups
    wr.init(1, 2);   // the loader's arrival + the TMA bytes; both consumers
    raw.init(1, 1);  // the loader's arrival + the TMA bytes; the producer warp
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kLoaderWarp) {
    setmaxnreg_dec<kLoaderRegs>();
    if (warp != kLoaderWarp) return;
    // Loader: lane 0 issues every TMA load as soon as its slot is free, the
    // raw rows and moments of chunk j and the W tile of chunk j - lead
    // (chunk j of the block's range: rows from (c0 + j) kTileRows).
    if (lane == 0)
      load_in_turn(
          chunks, Smem::kRawStages - Smem::kWStages,
          [&](int j) {
            raw.wait_empty(j);
            uint8_t* slot = sm + Smem::kRaw + raw.slot(j) * Smem::kRawSlot;
            const int r = (c0 + j) * kTileRows;
            mbar_arrive_expect_tx(raw.full(j), Smem::kRawSlot);
            tma_load_2d(slot, &maps.rows, (s0 / 4) * Rows::kGroupBytes, r, raw.full(j));
            tma_load_1d(slot + Smem::kRawBytes, &maps.mean, r, raw.full(j));
            tma_load_1d(slot + Smem::kRawBytes + 4 * kTileRows, &maps.inv_std, r,
                        raw.full(j));
          },
          [&](int j) {
            wr.wait_empty(j);
            uint8_t* wt = sm + Smem::kW + wr.slot(j) * kTileBytes;
            const int r = (c0 + j) * kTileRows;
            mbar_arrive_expect_tx(wr.full(j), kTileBytes);
            tma_load_2d(wt, &maps.w, l0, r, wr.full(j));
            tma_load_2d(wt + kPanelBytes, &maps.w, l0 + 64, r, wr.full(j));
          });
  } else if (warp >= 8) {
    setmaxnreg_dec<kProducerRegs>();
    // Producer warpgroup: warp pw decodes all rows of chunks pw, pw + 4,
    // ..., each once its raw rows have landed and its A slot is free, then
    // hands the slot to the consumers and the raw slot back.  Four chunks
    // in flight hide each warp's chain of waits, shared-memory latency and
    // fence.  Rows past D arrive as zeros (moments 0: values 0).
    uint32_t* tbl = reinterpret_cast<uint32_t*>(sm + Smem::kTbl) + (warp - 8) * kWarpRows * 16;
    for (int it = warp - 8; it < chunks; it += kProducerWarps) {
      raw.wait_full(it);
      a.wait_empty(it);
      const uint8_t* slot = sm + Smem::kRaw + raw.slot(it) * Smem::kRawSlot;
      const float* moments = reinterpret_cast<const float*>(slot + Smem::kRawBytes);
#pragma unroll
      for (int r0 = 0; r0 < kTileRows; r0 += kWarpRows)
        decode_rows<Rows>(slot, moments, moments + kTileRows,
                          sm + Smem::kA + a.slot(it) * kTileBytes, tbl, r0, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        raw.release(it);
        mbar_arrive(a.full(it));
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // Consumers: warpgroup wg owns samples s0 + 64 wg .. + 63.
    const int wg = warp / 4;
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      a.wait_full(c);
      wr.wait_full(c);
      const bool first = c % kLeftFoldChunks == 0;
      if (first && c > 0) fold(acc, tot);
      const uint32_t at = smem_u32(sm + Smem::kA + a.slot(c) * kTileBytes + wg * kPanelBytes);
      const uint32_t wt = smem_u32(sm + Smem::kW + wr.slot(c) * kTileBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 rows (2 swizzle atoms) per MMA
        wgmma_m64n128k16<1>(acc, desc_b128(at + 2048 * kk, kPanelBytes, 1024),
                            desc_b128(wt + 2048 * kk, kPanelBytes, 1024),
                            first && kk == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait<1>();  // chunk c - 1's MMAs are done: release its slots
      if (c > 0 && tid % 128 == 0) {
        a.release(c - 1);
        wr.release(c - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    store_tile(out + (size_t)blockIdx.z * 4 * groups * L, tot, acc, s0 + 64 * wg, l0,
               4 * groups, L, warp, lane);
  }
}

// Launchers shared by the packed and dense entry points.

// The launch of left2d_mma_kernel over D rows, rows of `groups` groups
// and L columns on `sms` SMs: a block per kTileSamples x kMmaCols output
// tile, each over every row; where those tiles are fewer than the SMs
// (narrow matrices: 2,048 samples give 16 tiles for 132 SMs) the rows
// split into grid.z ranges of `per` chunks, each a whole number of folds
// (min(SMs / tiles, folds) ranges), whose partial slabs sum_splits_kernel
// adds in a fixed order.  At 16,384 and 11,264 samples (128 and 88 tiles)
// there is one range: kernels 6 and 14 launch as without the split.
struct Left2dPlan {
  dim3 grid;
  int per;
};

inline Left2dPlan left2d_plan(int D, int groups, int L, int sms) {
  const int samples = (4 * groups + kTileSamples - 1) / kTileSamples;
  const int cols = (L + kMmaCols - 1) / kMmaCols;
  const int chunks = (D + kTileRows - 1) / kTileRows;
  const int folds = (chunks + kLeftFoldChunks - 1) / kLeftFoldChunks;
  const int tiles = std::max(1, samples * cols);
  int ranges = 1;
  if (tiles < sms) ranges = std::max(1, std::min(sms / tiles, folds));
  const int per = std::max(1, (folds + ranges - 1) / ranges) * kLeftFoldChunks;
  ranges = std::max(1, (chunks + per - 1) / per);
  return {dim3(samples, cols, ranges), per};
}

// The left product: the tensor-core kernel in bf16 mode (w bf16 (D, ldw);
// slab (ranges, 4 groups, L) f32 where the plan splits the rows), the f32
// loop in f32 mode (w f32 (D, L)).
template <class Rows>
int launch_left2d(Rows g, const void* mean, const void* inv_std, const void* w,
                  void* out, void* slab, int D, int L, int ldw, int bf16, int sms,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!bf16) {
    left2d_kernel<Rows><<<grid_of(4 * g.groups, L), kThreads, 0, st>>>(
        g, (const float*)mean, (const float*)inv_std, (const float*)w,
        (float*)out, D, L);
    return (int)cudaGetLastError();
  }
  const Left2dPlan p = left2d_plan(D, g.groups, L, sms);
  const int ranges = (int)p.grid.z;
  if (ranges > 1 && slab == nullptr) return (int)cudaErrorInvalidValue;
  LeftMmaMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (D > 0) {
    int rc = bf16_map(&maps.w, w, ldw, D);
    if (rc == 0) rc = rows_map(&maps.rows, g, D);
    if (rc == 0)
      rc = tensor_map(&maps.mean, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, mean, D,
                      0, kTileRows, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc == 0)
      rc = tensor_map(&maps.inv_std, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                      inv_std, D, 0, kTileRows, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  constexpr int smem = LeftMmaSmem<Rows>::kBytes;
  static OncePerDevice once;
  int rc = allow_smem(once, left2d_mma_kernel<Rows>, smem);
  if (rc != 0) return rc;
  left2d_mma_kernel<Rows><<<p.grid, kMmaThreads, smem, st>>>(
      maps, g.groups, (float*)(ranges > 1 ? slab : out), D, L, p.per);
  rc = (int)cudaGetLastError();
  if (rc != 0 || ranges == 1) return rc;
  return launch_sum_splits((const float*)slab, (float*)out, 4 * g.groups, L, L,
                           ranges, sms, st);
}

}  // namespace gp

extern "C" {

// out (N, L) = A^T W over packed rows of n4 bytes / dense rows of n4 words;
// w is bf16 (D, ldw) when bf16, else f32 (D, L); slab (ranges, 4 n4, L)
// f32 where gp_left2d_plan splits the rows (bf16 only), else unused.
int gp_left2d_packed(const void* packed, const void* mean, const void* inv_std,
                     const void* w, void* out, void* slab, int D, int n4, int L,
                     int ldw, int bf16, int sms, void* stream) {
  return gp::launch_left2d(gp::PackedRows{(const uint8_t*)packed, n4}, mean,
                           inv_std, w, out, slab, D, L, ldw, bf16, sms, stream);
}

int gp_left2d_dense(const void* geno, const void* mean, const void* inv_std,
                    const void* w, void* out, void* slab, int D, int n4, int L,
                    int ldw, int bf16, int sms, void* stream) {
  return gp::launch_left2d(gp::DenseRows{(const int8_t*)geno, n4}, mean,
                           inv_std, w, out, slab, D, L, ldw, bf16, sms, stream);
}

// The tile (samples, columns), grid (x, y) and row ranges (grid z) of the
// bf16 left product over D rows, rows of n4 groups and L columns on `sms`
// SMs, as launch_left2d launches it, into plan[0..4].
int gp_left2d_plan(int D, int n4, int L, int sms, int* plan) {
  const gp::Left2dPlan p = gp::left2d_plan(D, n4, L, sms);
  plan[0] = gp::kTileSamples;
  plan[1] = gp::kMmaCols;
  plan[2] = (int)p.grid.x;
  plan[3] = (int)p.grid.y;
  plan[4] = (int)p.grid.z;
  return 0;
}

}  // extern "C"
