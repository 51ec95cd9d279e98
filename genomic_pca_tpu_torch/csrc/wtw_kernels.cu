// W^T W on the tensor cores: the second half of the 1-D Rayleigh-Ritz tsq
// pass in bf16 mode (kernels 3 and 12, gp_tsq_packed / gp_tsq_dense of
// gram.cuh), over the bf16 W that right2d_mma_kernel stores.
//
// The TPU kernels (fused_tsq_packed, pallas_kernels.py :564, body
// _tsq_packed_kernel :472; fused_tsq :215, body _tsq_kernel :120) add
// wc^T wc, wc = bf16(x b), into one (L, L) VMEM accumulator through a
// sequential grid of row tiles (:484-486).  Here W (D, ldw) bf16 is in
// device memory, written once by the right product, and
//
//   out (L, L) f32 = sum over rows r of W[r]^T W[r]
//
// is wtw_mma_kernel: one block per 128 x 128 output tile (one at L <= 128,
// 2 x 2 at L = 130) and range of rows, each range a whole number of
// 1,024-row folds; ranges = min(SMs / tiles, folds), so that at 262,144 x
// 128 on 132 SMs 128 blocks take 2 folds each.  A loader warp issues TMA
// loads of W chunks (64 rows x 128 columns as two 64 x 64 boxes with the
// 128-byte swizzle, the tile's columns and, off the diagonal, the other
// tile's) into an mbarrier ring; two consumer warpgroups, one per 64
// output rows, issue wgmma m64n128k16 with both operands MN-major from the
// swizzled chunk (W^T as A with its columns contiguous, W as B: how
// left2d_mma_kernel reads its W), on the diagonal from the same slot.  No
// producer warpgroup: there is nothing to decode.  Every kFold rows the
// accumulator is folded into a register total; each range writes its
// partial into a slab (ranges, L, L) that sum_splits_kernel adds in a
// fixed order.  No atomics: a second launch gives the same bits.  Columns
// past L are zeros in W's pad or TMA's fill past ldw and past D, so they
// add nothing; only rows and columns < L are stored.
//
// Bound on an H100 at 262,144 x 128: W's 2 D ldw bytes (64 MiB) at 3.35
// TB/s, 20.0 us, against 2 D L^2 = 8.6e9 operations at 989 TFLOP/s bf16,
// 8.7 us: bound by bytes.  128 blocks of 2,048 rows each keep six 32 KB
// slots of W in flight an SM.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError() so that a refused launch is never silent.
#include "hopper.cuh"

namespace gp {

// Two consumer warpgroups and the loader warp (no setmaxnreg: 288 threads
// leave each up to 224 registers, and the consumers' accumulator and
// total take 128).
constexpr int kWtwThreads = 288;
constexpr int kWtwLoaderWarp = 8;
constexpr int kWtwFoldChunks = kFold / kTileRows;
static_assert(kFold % kTileRows == 0, "a fold falls between chunks");

// The ring (byte offsets from a 1024-byte aligned base): a slot holds a
// chunk's tile of the block's output rows, then that of its columns (left
// unused on the diagonal).
struct WtwSmem {
  static constexpr int kStages = 6;
  static constexpr int kSlot = 2 * kTileBytes;
  static constexpr int kBar = kStages * kSlot;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// out[z] (L, L) = sum of W[r]^T W[r] over the chunks [z per, (z + 1) per)
// of the rows, z = blockIdx.z, in output tile (blockIdx.x, blockIdx.y);
// out is the result when there is one range, else the slab of partials.
// `per` is a whole number of folds, so a range's folds are the unsplit
// kernel's.
__global__ void __launch_bounds__(kWtwThreads, 1)
wtw_mma_kernel(const __grid_constant__ CUtensorMap wmap, float* __restrict__ out,
               int D, int L, int per) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Ring<WtwSmem::kStages> ring{reinterpret_cast<uint64_t*>(sm + WtwSmem::kBar)};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = blockIdx.x * kMmaCols, j0 = blockIdx.y * kMmaCols;
  const bool diag = blockIdx.x == blockIdx.y;
  const int c0 = blockIdx.z * per;
  const int chunks = max(0, min((D + kTileRows - 1) / kTileRows, c0 + per) - c0);
  if (tid == 0) {
    ring.init(1, 2);  // the loader's arrival + the TMA bytes; both consumers
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWtwLoaderWarp) {
    // Loader: lane 0 issues chunk j's loads as soon as its slot is free.
    if (lane == 0)
      for (int j = 0; j < chunks; ++j) {
        ring.wait_empty(j);
        uint8_t* slot = sm + ring.slot(j) * WtwSmem::kSlot;
        const int r = (c0 + j) * kTileRows;
        mbar_arrive_expect_tx(ring.full(j), diag ? kTileBytes : 2 * kTileBytes);
        tma_load_2d(slot, &wmap, i0, r, ring.full(j));
        tma_load_2d(slot + kPanelBytes, &wmap, i0 + 64, r, ring.full(j));
        if (!diag) {
          tma_load_2d(slot + kTileBytes, &wmap, j0, r, ring.full(j));
          tma_load_2d(slot + kTileBytes + kPanelBytes, &wmap, j0 + 64, r, ring.full(j));
        }
      }
    return;
  }
  // Consumers: warpgroup wg owns output rows i0 + 64 wg .. + 63, the
  // columns of W in panel wg of the slot's first tile.
  const int wg = warp / 4;
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    ring.wait_full(c);
    const bool first = c % kWtwFoldChunks == 0;
    if (first && c > 0) fold(acc, tot);
    const uint32_t at = smem_u32(sm + ring.slot(c) * WtwSmem::kSlot);
    const uint32_t bt = diag ? at : at + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 rows (2 swizzle atoms) per MMA
      wgmma_m64n128k16<1>(acc, desc_b128(at + wg * kPanelBytes + 2048 * kk, kPanelBytes, 1024),
                          desc_b128(bt + 2048 * kk, kPanelBytes, 1024),
                          first && kk == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1's MMAs are done: release its slot
    if (c > 0 && tid % 128 == 0) ring.release(c - 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  store_tile(out + (size_t)blockIdx.z * L * L, tot, acc, i0 + 64 * wg, j0, L, L, warp,
             lane);
}

// The launch of wtw_mma_kernel over D rows and L columns on `sms` SMs: a
// block per kMmaCols x kMmaCols output tile, and the rows in grid.z ranges
// of `per` chunks, each a whole number of folds: min(SMs / tiles, folds)
// ranges, fewer where a range would be empty.
struct WtwPlan {
  dim3 grid;
  int per;
};

inline WtwPlan wtw_plan(int D, int L, int sms) {
  const int cols = std::max(1, (L + kMmaCols - 1) / kMmaCols);
  const int chunks = (D + kTileRows - 1) / kTileRows;
  const int folds = (chunks + kWtwFoldChunks - 1) / kWtwFoldChunks;
  const int tiles = cols * cols;
  int ranges = 1;
  if (tiles < sms) ranges = std::max(1, std::min(sms / tiles, folds));
  const int per = std::max(1, (folds + ranges - 1) / ranges) * kWtwFoldChunks;
  ranges = std::max(1, (chunks + per - 1) / per);
  return {dim3(cols, cols, ranges), per};
}

// w bf16 (D, ldw), ldw a multiple of 8 at least L; slab (ranges, L, L)
// f32 where the plan splits the rows, else unused.
inline int launch_wtw(const void* w, float* out, float* slab, int D, int L, int ldw,
                      int sms, cudaStream_t st) {
  const WtwPlan p = wtw_plan(D, L, sms);
  const int ranges = (int)p.grid.z;
  if (ranges > 1 && slab == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (D > 0) {
    const int rc = bf16_map(&map, w, ldw, D);
    if (rc != 0) return rc;
  }
  static OncePerDevice once;
  int rc = allow_smem(once, wtw_mma_kernel, WtwSmem::kBytes);
  if (rc != 0) return rc;
  wtw_mma_kernel<<<p.grid, kWtwThreads, WtwSmem::kBytes, st>>>(
      map, ranges > 1 ? slab : out, D, L, p.per);
  rc = (int)cudaGetLastError();
  if (rc != 0 || ranges == 1) return rc;
  return launch_sum_splits((const float*)slab, out, L, L, L, ranges, sms, st);
}

}  // namespace gp

extern "C" {

// out (L, L) f32 = W^T W, w bf16 (D, ldw); slab (ranges, L, L) f32 where
// gp_wtw_plan splits the rows, else unused.
int gp_wtw_mma(const void* w, void* out, void* slab, int D, int L, int ldw, int sms,
               void* stream) {
  return gp::launch_wtw(w, (float*)out, (float*)slab, D, L, ldw, sms,
                        (cudaStream_t)stream);
}

// The tile (rows, columns), grid (x, y) and row ranges (grid z) of W^T W
// over D rows and L columns on `sms` SMs, as gp_wtw_mma launches it, into
// plan[0..4].
int gp_wtw_plan(int D, int L, int sms, int* plan) {
  const gp::WtwPlan p = gp::wtw_plan(D, L, sms);
  plan[0] = gp::kMmaCols;
  plan[1] = gp::kMmaCols;
  plan[2] = (int)p.grid.x;
  plan[3] = (int)p.grid.y;
  plan[4] = (int)p.grid.z;
  return 0;
}

}  // extern "C"
