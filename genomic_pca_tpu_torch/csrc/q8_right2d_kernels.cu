// The q8 right products G0 bq of the wide-sample (2-D) mode, for both
// genotype layouts: q8_right2d_mma_kernel.  They replace
//
//   right_apply_2d_q8 (genomic_pca_tpu/ops/pallas_kernels.py :1096,
//        pallas_call :1112; body _right2d_q8_kernel :1057)
//        packed (_unpack_packed_tile_s8 :902)  -> gp_q8_right2d
//        int8 (_clean_i8 :1048)                -> gp_q8_right2d_dense
//
// out (D, L) f32 = G0 (D, N) bq (N, L): G0 the dosage with missing -> 0
// (packed codes {0, 1, 2, 3} -> {2, 0, 1, 0}; dense max(g, 0), so the -127
// sentinel is 0), bq int8.  The products and their sums are integers, and
// exact in int32 while 2 * 127 * N < 2^31; each entry is that int32 sum
// converted to f32 once, so the kernel equals the plain version bit for
// bit at every shape (the reference adds per-tile int32 sums in f32,
// which rounds differently once |sum| passes 2^24, about 66,000 samples).
//
// On an H100 at 65,536 x 16,384 x 128 the packed product is bound by the
// int8 tensor-core rate (2 D N L = 2.75e11 operations, 0.139 ms against
// 0.08 ms for its 256 MiB), the dense one by its 1 GiB of int8 (0.331
// ms).  Design, right2d_mma_kernel's (right2d_kernels.cu) with int8
// operands:
//   - one block per 128 rows x 128 columns of the output, looping over
//     the samples in chunks of kQ8Chunk; two consumer warpgroups, each
//     owning 64 rows, issue wgmma m64n128k32.s32.s8.s8 with both operands
//     K-major (the integer wgmma has no transposed form): A the decoded
//     int8 tile, B = bq^T (L, N), which the wrapper makes once a call
//     (q8_operand), in 128-sample x 128-column boxes with the 128-byte
//     swizzle.  A K step of 32 samples is a 32-byte advance in the
//     swizzle row, the next 128 samples the next panel;
//   - int32 accumulators: no fold, no f32 total, and a consumer releases
//     a chunk's slots as soon as its MMAs land;
//   - a loader warp issues every TMA load: packed, each chunk's raw bytes
//     as two 64-row half tiles into a raw ring, which a producer warp
//     decodes into the A ring (four bytes into sixteen int8 dosages by
//     two prmt; no moments, no per-row codes); dense, the raw int8 rows
//     straight into the A ring with the swizzle (they are G0 already up
//     to the clamp), which the producer warp then clamps in place
//     (max(g, 0) by a sign-replicating prmt) before it hands the slot on;
//   - TMA's zero fill decodes to dosage 2 in the packed layout: rows past
//     D are never stored, and samples past the rows meet zero columns of
//     bq^T (its pad entries are 0, and TMA fills past it with 0);
//   - thin strips (few row blocks, e.g. 2,000 x 16,384: 16 blocks for 132
//     SMs) split the samples into ranges (q8_right2d_plan), each writing
//     an int32 partial slab (splits, D, L) that sum_splits_kernel adds in
//     int32 in a fixed order and converts once: the same bits as one
//     range.
// The plan is chosen here and reported by gp_q8_right2d_plan, so that the
// wrapper can size the slab.
#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace gp {

constexpr int kQ8Rows = 2 * kTileRows;         // rows of a block, a half each WG
constexpr int kQ8Chunk = 256;                  // samples of a chunk
constexpr int kQ8Panels = kQ8Chunk / 128;      // 128-sample panels a chunk
constexpr int kQ8Panel = kTileRows * 128;      // 64 rows x 128 int8 (8 KB)
constexpr int kQ8Half = kQ8Panels * kQ8Panel;  // an A half tile (16 KB)
constexpr int kQ8BPanel = kMmaCols * 128;      // 128 columns x 128 int8
constexpr int kQ8BBytes = kQ8Panels * kQ8BPanel;
// A sample range of a split holds at least 1,024 samples (kernel 5's fold).
constexpr int kQ8RangeChunks = 1024 / kQ8Chunk > 0 ? 1024 / kQ8Chunk : 1;
static_assert(kQ8Chunk % 128 == 0, "whole 128-sample panels");
// Registers per thread after the hand-over: the int32 accumulator frees
// kernel 5's 64 registers of f32 total, and the decode needs no codes, so
// the producer keeps its 128 and the consumers take 168.
constexpr int kQ8ConsumerRegs = 168, kQ8ProducerRegs = 128;
static_assert(128 * (2 * kQ8ConsumerRegs + kQ8ProducerRegs + kLoaderRegs) <= 65536,
              "the register file");

// Ring depths and the shared-memory layout (byte offsets from a 1024-byte
// aligned base).  Item 2c + h of the A ring is half h of chunk c; the B
// ring holds whole chunks.
//   Packed: RightMmaSmem's depths and their parity order (a raw slot
//     serves one producer warp; a producer waits for its A slot by parity,
//     safe because the loader's B waits keep item it - 2 kAStages
//     released: kAStages >= kLead + kBStages + 1).
//   Dense: no raw ring: TMA writes the A slot, whose "landed" barrier the
//     producer waits on; kAStages a multiple of the producer warps, so a
//     slot serves one producer warp (its landed waits see every round),
//     and 8 slots keep four chunks in flight.
template <class Rows>
struct Q8RightSmem {
  static constexpr bool kPacked = Rows::kGroupBytes == 1;
  static constexpr int kAStages = kPacked ? 6 : 8;
  static constexpr int kBStages = 3;
  static constexpr int kRawStages = kPacked ? 8 : 0;
  static constexpr int kLead = (kPacked ? kRawStages : kAStages) / 2 - kBStages;
  static_assert(kLead >= 0, "the loader's lead");
  static_assert(kAStages % 2 == 0, "an A slot serves one consumer warpgroup");
  static_assert(kPacked ? kRawStages % kProducerWarps == 0 &&
                              kAStages >= kLead + kBStages + 1
                        : kAStages % kProducerWarps == 0,
                "a waiter a slot, and the A ring's parity order");
  static constexpr int kRawBytes = kTileRows * kQ8Chunk / 4;  // 64 rows of bytes
  static constexpr int kA = 0;
  static constexpr int kB = kA + kAStages * kQ8Half;
  static constexpr int kRaw = kB + kBStages * kQ8BBytes;
  static constexpr int kBar = kRaw + kRawStages * kRawBytes;
  static constexpr int kBars = 2 * (kAStages + kBStages + kRawStages) + (kPacked ? 0 : kAStages);
  static constexpr int kBytes = kBar + kBars * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

constexpr int kQ8RowWords = kQ8Chunk / 16;  // packed bytes of a chunk row, in words

// An A half tile (64 rows x kQ8Chunk samples) from its raw packed bytes
// (row r at src[r * kQ8RowWords ..]), one warp: lane turns word w = lane %
// kQ8RowWords of every (32 / kQ8RowWords)-th row into samples 16 w ..
// 16 w + 15, one 16-byte chunk of the swizzled panel row (panel w / 8,
// chunk w % 8).  Loads go out in batches before their stores (which may
// alias them), so that a row's store does not wait on the next load.
__device__ __forceinline__ void decode_q8_half(const uint32_t* src, uint8_t* tile,
                                               int lane) {
  constexpr int kStep = 32 / kQ8RowWords, kBatch = 8;
  const int w = lane % kQ8RowWords, r0 = lane / kQ8RowWords;
  uint8_t* dst = tile + (w / 8) * kQ8Panel;
#pragma unroll
  for (int i0 = 0; i0 < kTileRows / kStep; i0 += kBatch) {
    uint32_t x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) x[k] = src[(kStep * (i0 + k) + r0) * kQ8RowWords + w];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      *reinterpret_cast<uint4*>(dst + swz128(kStep * (i0 + k) + r0, w % 8)) =
          packed_g0_16(x[k]);
  }
}

// G0 = max(g, 0) of an A half tile of dense rows in place, 16 bytes a
// lane at a time (the clamp is elementwise: the swizzle does not matter).
__device__ __forceinline__ void clean_q8_half(uint8_t* tile, int lane) {
  constexpr int kVecs = kQ8Half / (16 * 32), kBatch = 8;
  uint4* t = reinterpret_cast<uint4*>(tile);
#pragma unroll
  for (int i0 = 0; i0 < kVecs; i0 += kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = t[(i0 + k) * 32 + lane];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      t[(i0 + k) * 32 + lane] = make_uint4(dense_g0(v[k].x), dense_g0(v[k].y),
                                           dense_g0(v[k].z), dense_g0(v[k].w));
  }
}

// The tensor maps of one launch: bq^T (L, ldq) int8 and the genotype rows.
struct Q8RightMaps {
  CUtensorMap b, rows;
};

// Writes a consumer warpgroup's 64 x 128 int32 result into out (row stride
// L) at rows r0.., columns l0..: converted to f32 once, or as int32 (a
// split's slab); rows >= n_rows and columns >= L are not written.
template <class Out>
__device__ __forceinline__ void store_q8_tile(Out* __restrict__ out,
                                              const int (&acc)[64], int r0, int l0,
                                              int n_rows, int L, int warp, int lane) {
  const int row = r0 + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row + 8 * h, col = l0 + 8 * j + 2 * (lane % 4) + e;
        const int i = 4 * j + 2 * h + e;
        if (r < n_rows && col < L) {
          if constexpr (std::is_same<Out, float>::value) {
            out[(size_t)r * L + col] = __int2float_rn(acc[i]);
          } else {
            out[(size_t)r * L + col] = acc[i];
          }
        }
      }
}

// out[z] (D, L) = G0 bq over the chunks [z per, (z + 1) per) of the N
// samples, z = blockIdx.z: the result (f32) when there is one range, else
// the int32 slab of partials.
template <class Rows, class Out>
__global__ void __launch_bounds__(kMmaThreads, 1)
q8_right2d_mma_kernel(const __grid_constant__ Q8RightMaps maps,
                      Out* __restrict__ out, int D, int N, int L, int per) {
  using Smem = Q8RightSmem<Rows>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Smem::kBar);
  const Ring<Smem::kAStages> a{bars};
  const Ring<Smem::kBStages> b{bars + 2 * Smem::kAStages};
  const Ring<Smem::kRawStages> raw{bars + 2 * (Smem::kAStages + Smem::kBStages)};
  // Dense: barrier s completes when TMA has written A slot s.
  uint64_t* landed = bars + 2 * (Smem::kAStages + Smem::kBStages + Smem::kRawStages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d0 = blockIdx.x * kQ8Rows, l0 = blockIdx.y * kMmaCols;
  const int c0 = blockIdx.z * per;
  const int chunks = max(0, min((N + kQ8Chunk - 1) / kQ8Chunk, c0 + per) - c0);
  if (tid == 0) {
    a.init(1, 1);  // the producer warp of the item; its consumer warpgroup
    b.init(1, 2);  // the loader's arrival + the TMA bytes; both consumers
    if constexpr (Smem::kPacked) {
      raw.init(1, 1);  // the loader's arrival + the TMA bytes; the producer warp
    } else {
      for (int s = 0; s < Smem::kAStages; ++s) mbar_init(&landed[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kLoaderWarp) {
    setmaxnreg_dec<kLoaderRegs>();
    if (warp != kLoaderWarp) return;
    // Loader: lane 0 issues every TMA load as soon as its slot is free,
    // the two half tiles of chunk j (raw bytes, or the dense rows into the
    // A slot) and the B tile of chunk j - kLead.
    if (lane == 0)
      load_in_turn(
          chunks, Smem::kLead,
          [&](int j) {
            const int s = (c0 + j) * kQ8Chunk;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int it = 2 * j + h;
              if constexpr (Smem::kPacked) {
                raw.wait_empty(it);
                mbar_arrive_expect_tx(raw.full(it), Smem::kRawBytes);
                tma_load_2d(sm + Smem::kRaw + raw.slot(it) * Smem::kRawBytes, &maps.rows,
                            s / 4, d0 + kTileRows * h, raw.full(it));
              } else {
                a.wait_empty(it);
                uint64_t* bar = &landed[a.slot(it)];
                mbar_arrive_expect_tx(bar, kQ8Half);
                uint8_t* at = sm + Smem::kA + a.slot(it) * kQ8Half;
#pragma unroll
                for (int p = 0; p < kQ8Panels; ++p)
                  tma_load_2d(at + p * kQ8Panel, &maps.rows, s + 128 * p,
                              d0 + kTileRows * h, bar);
              }
            }
          },
          [&](int j) {
            b.wait_empty(j);
            uint8_t* bt = sm + Smem::kB + b.slot(j) * kQ8BBytes;
            mbar_arrive_expect_tx(b.full(j), kQ8BBytes);
#pragma unroll
            for (int p = 0; p < kQ8Panels; ++p)
              tma_load_2d(bt + p * kQ8BPanel, &maps.b, (c0 + j) * kQ8Chunk + 128 * p, l0,
                          b.full(j));
          });
  } else if (warp >= 8) {
    // Producer warp pw: items pw, pw + 4, ... (always half pw % 2), each
    // once its bytes have landed and (packed) its A slot is free; then it
    // hands the A slot to the consumers (and the raw slot back).
    const int pw = warp - 8;
    for (int it = pw; it < 2 * chunks; it += kProducerWarps) {
      uint8_t* tile = sm + Smem::kA + a.slot(it) * kQ8Half;
      if constexpr (Smem::kPacked) {
        raw.wait_full(it);
        a.wait_empty(it);
        decode_q8_half(reinterpret_cast<const uint32_t*>(
                           sm + Smem::kRaw + raw.slot(it) * Smem::kRawBytes),
                       tile, lane);
      } else {
        mbar_wait(&landed[a.slot(it)], (it / Smem::kAStages) & 1);
        clean_q8_half(tile, lane);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        if constexpr (Smem::kPacked) raw.release(it);
        mbar_arrive(a.full(it));
      }
    }
  } else {
    setmaxnreg_inc<kQ8ConsumerRegs>();
    // Consumers: warpgroup wg owns rows d0 + 64 wg .. + 63, items 2c + wg.
    const int wg = warp / 4;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int c = 0; c < chunks; ++c) {
      const int it = 2 * c + wg;
      a.wait_full(it);
      b.wait_full(c);
      const uint32_t at = smem_u32(sm + Smem::kA + a.slot(it) * kQ8Half);
      const uint32_t bt = smem_u32(sm + Smem::kB + b.slot(c) * kQ8BBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ8Chunk / 32; ++kk)  // 32 samples per MMA
        wgmma_m64n128k32_s8(
            acc, desc_b128(at + (kk / 4) * kQ8Panel + 32 * (kk % 4), 16, 1024),
            desc_b128(bt + (kk / 4) * kQ8BPanel + 32 * (kk % 4), 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();  // the chunk's MMAs landed: release its slots at once
      if (tid % 128 == 0) {
        a.release(it);
        b.release(c);
      }
    }
    fence_regs(acc);
    store_q8_tile(out + (size_t)blockIdx.z * D * L, acc, d0 + kTileRows * wg, l0, D, L,
                  warp, lane);
  }
}

// The launch of q8_right2d_mma_kernel over D rows, N samples and L columns
// on `sms` SMs: a block per kQ8Rows x kMmaCols output tile, and where
// those are fewer than the SMs, the samples split into grid.z ranges of
// `per` chunks (about one block per SM; each range at least 1,024
// samples), right2d_plan's rule.
struct Q8RightPlan {
  dim3 grid;
  int per;
};

inline Q8RightPlan q8_right2d_plan(int D, int N, int L, int sms) {
  const int rows = (D + kQ8Rows - 1) / kQ8Rows;
  const int cols = (L + kMmaCols - 1) / kMmaCols;
  const int chunks = (N + kQ8Chunk - 1) / kQ8Chunk;
  const int tiles = std::max(1, rows * cols);
  int splits = 1;
  if (tiles < sms) splits = std::max(1, std::min(sms / tiles, chunks / kQ8RangeChunks));
  const int per = std::max(1, (chunks + splits - 1) / splits);
  splits = std::max(1, (chunks + per - 1) / per);
  return {dim3(rows, cols, splits), per};
}

// Rows of 4 * groups samples: packed bytes, read in boxes of a chunk's
// bytes x 64 rows; dense int8 rows with the 128-byte swizzle, the A
// slot's layout.
inline int q8_rows_map(CUtensorMap* map, PackedRows g, int D) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.p, g.groups, D,
                    kQ8Chunk / 4, kTileRows, CU_TENSOR_MAP_SWIZZLE_NONE);
}

inline int q8_rows_map(CUtensorMap* map, DenseRows g, int D) {
  return i8_map(map, g.p, 4 * g.groups, D, kTileRows);
}

// bqt int8 (>= L rows, ldq), zero past N in every row read; out (D, L)
// f32; slab (splits, D, L) int32 when the plan splits the samples, added
// by sum_splits_kernel in int32 and converted once.
template <class Rows>
int launch_q8_right2d(Rows g, const void* bqt, float* out, int* slab, int D, int L,
                      int ldq, int sms, void* stream) {
  if (D <= 0 || L <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int N = 4 * g.groups;
  const Q8RightPlan p = q8_right2d_plan(D, N, L, sms);
  const int splits = (int)p.grid.z;
  if (splits > 1 && slab == nullptr) return (int)cudaErrorInvalidValue;
  Q8RightMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (N > 0) {
    int rc = i8_map(&maps.b, bqt, ldq, L, kMmaCols);
    if (rc == 0) rc = q8_rows_map(&maps.rows, g, D);
    if (rc != 0) return rc;
  }
  constexpr int smem = Q8RightSmem<Rows>::kBytes;
  if (splits > 1) {
    static OncePerDevice once;
    int rc = allow_smem(once, q8_right2d_mma_kernel<Rows, int>, smem);
    if (rc != 0) return rc;
    q8_right2d_mma_kernel<Rows, int><<<p.grid, kMmaThreads, smem, st>>>(
        maps, slab, D, N, L, p.per);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    return launch_sum_splits(static_cast<const int*>(slab), out, D, L, L, splits, sms,
                             st);
  }
  static OncePerDevice once;
  const int rc = allow_smem(once, q8_right2d_mma_kernel<Rows, float>, smem);
  if (rc != 0) return rc;
  q8_right2d_mma_kernel<Rows, float><<<p.grid, kMmaThreads, smem, st>>>(
      maps, out, D, N, L, p.per);
  return (int)cudaGetLastError();
}

}  // namespace gp

extern "C" {

// out (D, L) f32 = G0 bq over packed rows of n4 bytes / dense rows of n4
// words, N = 4 n4 samples; bqt int8 (L, ldq) = bq^T, zero in columns N..
// (ldq a multiple of 16); slab (splits, D, L) int32 where
// gp_q8_right2d_plan splits the samples, else unused.
int gp_q8_right2d(const void* packed, const void* bqt, void* out, void* slab, int D,
                  int n4, int L, int ldq, int sms, void* stream) {
  return gp::launch_q8_right2d(gp::PackedRows{(const uint8_t*)packed, n4}, bqt,
                               (float*)out, (int*)slab, D, L, ldq, sms, stream);
}

int gp_q8_right2d_dense(const void* geno, const void* bqt, void* out, void* slab,
                        int D, int n4, int L, int ldq, int sms, void* stream) {
  return gp::launch_q8_right2d(gp::DenseRows{(const int8_t*)geno, n4}, bqt,
                               (float*)out, (int*)slab, D, L, ldq, sms, stream);
}

// The tile (rows, columns), grid (x, y) and sample splits (grid z) of the
// q8 right product over D rows, N samples and L columns on `sms` SMs, as
// launch_q8_right2d launches it, into plan[0..4].
int gp_q8_right2d_plan(int D, int N, int L, int sms, int* plan) {
  const gp::Q8RightPlan p = gp::q8_right2d_plan(D, N, L, sms);
  plan[0] = gp::kQ8Rows;
  plan[1] = gp::kMmaCols;
  plan[2] = (int)p.grid.x;
  plan[3] = (int)p.grid.y;
  plan[4] = (int)p.grid.z;
  return 0;
}

}  // extern "C"
