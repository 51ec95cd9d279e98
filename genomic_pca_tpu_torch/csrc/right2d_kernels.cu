// The right products A B of the wide-sample (2-D) mode in bf16 mode, for
// both genotype layouts: right2d_mma_kernel.  They replace
//
//   fused_right_apply_2d_packed (genomic_pca_tpu/ops/pallas_kernels.py :675,
//        pallas_call :692; body _right2d_packed_kernel :642) -> gp_right2d_packed
//   fused_right_apply_2d        (:296, pallas_call :313; body
//        _right2d_kernel :263)                               -> gp_right2d_dense
//
// out (D, L) f32 = A (D, N) B (N, L): A the reference's bf16 tile, B rounded
// to bf16 once by the wrapper, sums in f32, out not rounded (the reference
// accumulates W in f32).  f32 mode ("HIGHEST" in the reference) is the f32
// FMA loop right_kernel (gp_right_packed / gp_right_dense): the wrapper
// dispatches on the precision.
//
// On an H100 at 65,536 x 16,384 x 128 the packed product is bound by the
// bf16 tensor-core rate (2 D N L = 2.75e11 operations, 0.278 ms), the
// dense one by its 1 GiB of int8 (0.333 ms).  Design, the left product's
// (wide_kernels.cu) turned over:
//   - one block per 128 rows x 128 columns of the output, looping over
//     the samples in chunks of 128; two consumer warpgroups, each owning
//     64 rows, issue wgmma m64n128k16 with A K-major (the decoded tile read
//     with the rows as M: a K step of 16 samples is a 32-byte advance in
//     the swizzle row, the next 64 samples the next panel) and B MN-major
//     (the basis in 64 x 64 boxes with the 128-byte swizzle, as the left
//     product reads W);
//   - a loader warp issues every TMA load: each chunk's raw rows, as two
//     64-row half tiles of 32 groups, and its B tile (every block streams
//     all of B from L2: N L 2 bytes);
//   - the block's rows never change, so their codes (the nibble pairs of
//     a packed row, the bf16x2 scale and shift of a dense one) are built
//     once a block from the moments, not once a chunk; a producer warp
//     then decodes a half tile straight into the A ring (decode_rows_with
//     of hopper.cuh), each warp always the same half, four half tiles in
//     flight;
//   - every kFold samples the accumulator is folded into a register total;
//   - thin strips (few row blocks, e.g. 2,000 x 16,384: 16 blocks for 132
//     SMs) split the samples into ranges, so that the grid reaches about
//     one block per SM; each range writes a partial (splits, D, L) slab
//     that sum_splits_kernel adds in a fixed order.  No atomics: the same
//     inputs give the same bits at every shape.
// The split is chosen here (right2d_plan) and reported by gp_right2d_plan,
// so that the wrapper can size the slab.
// What holds it above its bound (about 1.9x in raw launches, PERF.md): a
// chunk's decode of two half tiles and some 200 KB of shared-memory
// traffic (each consumer's wgmma reads its 16 KB of A and all 32 KB of B,
// the TMA and decode writes) against 0.56 us of MMA at peak.  So a
// consumer releases its slots as soon as its chunk's MMAs land, which
// keeps more half tiles in decode.
#include <algorithm>

#include "hopper.cuh"

namespace gp {

constexpr int kRightRows = 2 * kTileRows;  // rows of a block, a half each WG
constexpr int kFoldChunks = kFold / kTileSamples;
static_assert(kFold % kTileSamples == 0, "a fold falls between chunks");
// Registers per thread after the hand-over: the left product's split moves
// 8 from each consumer to the producer, whose packed decode, with its
// block's codes, spilled 96 bytes in its loop at 104 (12 at 120, and the
// packed launch ran 4% faster on an H100).
constexpr int kRightConsumerRegs = 184, kRightProducerRegs = 120;
static_assert(128 * (2 * kRightConsumerRegs + kRightProducerRegs + kLoaderRegs) <= 65536,
              "the register file");

// Ring depths and the shared-memory layout (byte offsets from a 1024-byte
// aligned base).  The A and raw rings hold half tiles (item 2c + h is half
// h of chunk c); the B ring whole chunks (32 KB: two 64-sample halves of
// two 64-column panels).  A consumer holds its item only while the
// chunk's MMAs run, the producers four, hence 6 A slots; 8 raw slots let
// four more land while four are decoded.  The dense raw slots take 8 KB,
// so its B ring is two deep (a 2-deep ring cost the packed one 25%).  The
// block's codes follow the rings.
template <class Rows>
struct RightMmaSmem {
  static constexpr bool kPacked = Rows::kGroupBytes == 1;
  static constexpr int kAStages = 6;
  static constexpr int kBStages = kPacked ? 3 : 2;
  static constexpr int kRawStages = 8;
  // A slot's fills come in round order (each waits for the last release),
  // so a waiter that waited the slot's previous round itself cannot be
  // fooled by the parity of a round still in flight: an A slot serves one
  // consumer warpgroup (its half), a raw slot one producer warp.
  static_assert(kAStages % 2 == 0 && kRawStages % kProducerWarps == 0,
                "a waiter a slot");
  // The raw loads of chunk j go out with the B tile of chunk j - kLead.
  static constexpr int kLead = kRawStages / 2 - kBStages;
  static_assert(kLead >= 0, "the loader's raw lead");
  // A producer waits for its A slot by parity alone, which is safe only
  // while item it - 2 kAStages has been released.  The loader's B waits
  // guarantee it: raw(it), it = 2j + h, goes out after B(j - 1 - kLead)
  // did, i.e. after the release of every item below 2 (j - kLead -
  // kBStages) (a B slot is released once both halves of its chunk are).
  static_assert(kAStages >= kLead + kBStages + 1, "the A ring's parity order");
  static constexpr int kRawBytes = kTileRows * 32 * Rows::kGroupBytes;
  static constexpr int kBBytes = 2 * kTileBytes;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kAStages * kTileBytes;
  static constexpr int kRaw = kB + kBStages * kBBytes;
  static constexpr int kCodes = kRaw + kRawStages * kRawBytes;
  static constexpr int kBar = kCodes + kRightRows * kCodeWords<Rows> * 4;
  static constexpr int kBytes =
      kBar + 2 * (kAStages + kBStages + kRawStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// The tensor maps of one launch: B (N, ldb) bf16 and the genotype rows.
struct RightMmaMaps {
  CUtensorMap b, rows;
};

// out[z] (D, L) = A B over the chunks [z per, (z + 1) per) of the samples,
// z = blockIdx.z, N samples (B's rows); out is the result when there is
// one range, else the slab of partials.
template <class Rows>
__global__ void __launch_bounds__(kMmaThreads, 1)
right2d_mma_kernel(const __grid_constant__ RightMmaMaps maps,
                   const float* __restrict__ mean,
                   const float* __restrict__ inv_std, float* __restrict__ out,
                   int D, int N, int L, int per) {
  using Smem = RightMmaSmem<Rows>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Smem::kBar);
  const Ring<Smem::kAStages> a{bars};
  const Ring<Smem::kBStages> b{bars + 2 * Smem::kAStages};
  const Ring<Smem::kRawStages> raw{bars + 2 * (Smem::kAStages + Smem::kBStages)};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d0 = blockIdx.x * kRightRows, l0 = blockIdx.y * kMmaCols;
  const int c0 = blockIdx.z * per;
  const int chunks = max(0, min((N + kTileSamples - 1) / kTileSamples, c0 + per) - c0);
  if (tid == 0) {
    a.init(1, 1);    // the producer warp of the half; its consumer warpgroup
    b.init(1, 2);    // the loader's arrival + the TMA bytes; both consumers
    raw.init(1, 1);  // the loader's arrival + the TMA bytes; the producer warp
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kLoaderWarp) {
    setmaxnreg_dec<kLoaderRegs>();
    if (warp != kLoaderWarp) return;
    // Loader: lane 0 issues every TMA load as soon as its slot is free, the
    // two raw half tiles of chunk j and the B tile of chunk j - kLead.
    if (lane == 0)
      load_in_turn(
          chunks, Smem::kLead,
          [&](int j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int it = 2 * j + h;
              raw.wait_empty(it);
              mbar_arrive_expect_tx(raw.full(it), Smem::kRawBytes);
              tma_load_2d(sm + Smem::kRaw + raw.slot(it) * Smem::kRawBytes, &maps.rows,
                          (c0 + j) * 32 * Rows::kGroupBytes, d0 + kTileRows * h,
                          raw.full(it));
            }
          },
          [&](int j) {
            b.wait_empty(j);
            uint8_t* bt = sm + Smem::kB + b.slot(j) * Smem::kBBytes;
            mbar_arrive_expect_tx(b.full(j), Smem::kBBytes);
            const int s = (c0 + j) * kTileSamples;
#pragma unroll
            for (int k = 0; k < 2; ++k)  // 64-sample halves
#pragma unroll
              for (int q = 0; q < 2; ++q)  // 64-column panels
                tma_load_2d(bt + (2 * k + q) * kPanelBytes, &maps.b, l0 + 64 * q,
                            s + 64 * k, b.full(j));
          });
  } else if (warp >= 8) {
    setmaxnreg_dec<kRightProducerRegs>();
    // Producer warpgroup.  First the codes of the block's rows, one row a
    // thread (rows past D: scale and shift 0, so their values are 0).
    uint32_t* codes = reinterpret_cast<uint32_t*>(sm + Smem::kCodes);
    const int r = tid - 8 * 32, d = d0 + r;
    const RowScale s = d < D ? row_scale(mean, inv_std, d, true) : RowScale{0.f, 0.f};
    row_codes<Rows>(s, codes + r * kCodeWords<Rows>);
    named_sync(1, 4 * 32);
    // Then warp pw decodes items pw, pw + 4, ...: always half pw % 2.  Each
    // item once its raw rows have landed and its A slot is free; then it
    // hands the slot to the consumers and the raw slot back.
    const int pw = warp - 8;
    const uint32_t* half = codes + (pw & 1) * kTileRows * kCodeWords<Rows>;
    for (int it = pw; it < 2 * chunks; it += kProducerWarps) {
      raw.wait_full(it);
      a.wait_empty(it);
      const uint8_t* slot = sm + Smem::kRaw + raw.slot(it) * Smem::kRawBytes;
      uint8_t* tile = sm + Smem::kA + a.slot(it) * kTileBytes;
#pragma unroll
      for (int r0 = 0; r0 < kTileRows; r0 += kWarpRows)
        decode_rows_with<Rows>(slot, tile, r0, lane,
                               SharedCodes<Rows>{half + r0 * kCodeWords<Rows>});
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        raw.release(it);
        mbar_arrive(a.full(it));
      }
    }
  } else {
    setmaxnreg_inc<kRightConsumerRegs>();
    // Consumers: warpgroup wg owns rows d0 + 64 wg .. + 63, items 2c + wg.
    const int wg = warp / 4;
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int it = 2 * c + wg;
      a.wait_full(it);
      b.wait_full(c);
      const bool first = c % kFoldChunks == 0;
      if (first && c > 0) fold(acc, tot);
      const uint32_t at = smem_u32(sm + Smem::kA + a.slot(it) * kTileBytes);
      const uint32_t bt = smem_u32(sm + Smem::kB + b.slot(c) * Smem::kBBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)  // 16 samples per MMA
        wgmma_m64n128k16<0>(
            acc, desc_b128(at + (kk / 4) * kPanelBytes + 32 * (kk % 4), 16, 1024),
            desc_b128(bt + (kk / 4) * 2 * kPanelBytes + 2048 * (kk % 4), kPanelBytes, 1024),
            first && kk == 0 ? 0 : 1);
      wgmma_commit();
      // Wait for this chunk's MMAs and release its slots at once: the
      // decode, not the MMA, sets the pace, and a slot held one chunk
      // longer is a half tile fewer in decode (on an H100 a dense launch
      // at 65,536 x 16,384 took 0.86 ms holding it, 0.65 ms releasing it).
      wgmma_wait<0>();
      if (tid % 128 == 0) {
        a.release(it);
        b.release(c);
      }
    }
    fence_regs(acc);
    store_tile(out + (size_t)blockIdx.z * D * L, tot, acc, d0 + kTileRows * wg, l0,
               D, L, warp, lane);
  }
}

// out[i] = sum over z of slab[z][i], z in order.
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ slab, float* __restrict__ out,
                  size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    float s = slab[i];
    for (int z = 1; z < splits; ++z) s += slab[z * n + i];
    out[i] = s;
  }
}

// The launch of right2d_mma_kernel over D rows, N samples and L columns on
// `sms` SMs: a block per kRightRows x kMmaCols output tile, and where
// those are fewer than the SMs, the samples split into grid.z ranges of
// `per` chunks (about one block per SM; each range at least a fold).
struct Right2dPlan {
  dim3 grid;
  int per;
};

inline Right2dPlan right2d_plan(int D, int N, int L, int sms) {
  const int rows = (D + kRightRows - 1) / kRightRows;
  const int cols = (L + kMmaCols - 1) / kMmaCols;
  const int chunks = (N + kTileSamples - 1) / kTileSamples;
  const int tiles = std::max(1, rows * cols);
  int splits = 1;
  if (tiles < sms) splits = std::max(1, std::min(sms / tiles, chunks / kFoldChunks));
  const int per = std::max(1, (chunks + splits - 1) / splits);
  splits = std::max(1, (chunks + per - 1) / per);
  return {dim3(rows, cols, splits), per};
}

// b bf16 (N, ldb), columns >= L zero; slab (splits, D, L) f32 when the
// plan splits the samples.
template <class Rows>
int launch_right2d(Rows g, const void* mean, const void* inv_std, const void* b,
                   void* out, void* slab, int D, int N, int L, int ldb, int sms,
                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Right2dPlan p = right2d_plan(D, N, L, sms);
  const int splits = (int)p.grid.z;
  if (splits > 1 && slab == nullptr) return (int)cudaErrorInvalidValue;
  RightMmaMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (D > 0 && N > 0) {
    int rc = bf16_map(&maps.b, b, ldb, N);
    if (rc == 0) rc = rows_map(&maps.rows, g, D);
    if (rc != 0) return rc;
  }
  constexpr int smem = RightMmaSmem<Rows>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      right2d_mma_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  right2d_mma_kernel<Rows><<<p.grid, kMmaThreads, smem, st>>>(
      maps, (const float*)mean, (const float*)inv_std,
      (float*)(splits > 1 ? slab : out), D, N, L, p.per);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  const size_t n = (size_t)D * L;
  const int blocks = (int)std::min<size_t>((n + kThreads - 1) / kThreads, 4 * sms);
  sum_splits_kernel<<<blocks, kThreads, 0, st>>>((const float*)slab, (float*)out,
                                                 n, splits);
  return (int)cudaGetLastError();
}

}  // namespace gp

extern "C" {

// out (D, L) = A B over packed rows of n4 bytes / dense rows of n4 words
// (at least N / 4), N samples; b bf16 (N, ldb).
int gp_right2d_packed(const void* packed, const void* mean, const void* inv_std,
                      const void* b, void* out, void* slab, int D, int n4, int N,
                      int L, int ldb, int sms, void* stream) {
  return gp::launch_right2d(gp::PackedRows{(const uint8_t*)packed, n4}, mean,
                            inv_std, b, out, slab, D, N, L, ldb, sms, stream);
}

int gp_right2d_dense(const void* geno, const void* mean, const void* inv_std,
                     const void* b, void* out, void* slab, int D, int n4, int N,
                     int L, int ldb, int sms, void* stream) {
  return gp::launch_right2d(gp::DenseRows{(const int8_t*)geno, n4}, mean,
                            inv_std, b, out, slab, D, N, L, ldb, sms, stream);
}

// The tile (rows, columns), grid (x, y) and sample splits (grid z) of the
// bf16 right product over D rows, N samples and L columns on `sms` SMs,
// as launch_right2d launches it, into plan[0..4].
int gp_right2d_plan(int D, int N, int L, int sms, int* plan) {
  const gp::Right2dPlan p = gp::right2d_plan(D, N, L, sms);
  plan[0] = gp::kRightRows;
  plan[1] = gp::kMmaCols;
  plan[2] = (int)p.grid.x;
  plan[3] = (int)p.grid.y;
  plan[4] = (int)p.grid.z;
  return 0;
}

}  // extern "C"
