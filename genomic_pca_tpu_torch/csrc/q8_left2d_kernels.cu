// The q8 left products sum_t sz[t] G0_t^T z8_t of the wide-sample (2-D)
// mode, for both genotype layouts: q8_left2d_mma_kernel.  They replace
//
//   left_apply_2d_q8 (genomic_pca_tpu/ops/pallas_kernels.py :1139,
//        pallas_call :1158; body _left2d_q8_kernel :1073)
//        packed (_unpack_packed_tile_s8 :902)  -> gp_q8_left2d
//        int8 (_clean_i8 :1048)                -> gp_q8_left2d_dense
//
// out (N, L) f32 = sum over row tiles t of sz[t] (G0_t^T z8_t): G0 the
// dosage with missing -> 0 (packed codes {0, 1, 2, 3} -> {2, 0, 1, 0};
// dense max(g, 0)), z8 (D, L) int8 quantized per row tile of tile_d rows,
// sz (T,) f32 its scales.  Inside a tile the product is an exact int32 sum
// (2 * 127 * tile_d < 2^31); sums under different scales cannot be added
// as integers, so at every tile boundary the int32 sum is scaled by that
// tile's sz and added to an f32 total, in tile order, one rounding per
// multiply and one per add: the reference kernel's tile order (its
// row-tile grid axis is sequential; XLA on the CPU contracts its multiply
// and add into one FMA) and, bit for bit, the plain version's.
//
// On an H100 at 65,536 x 16,384 x 128 the packed product is bound by the
// int8 tensor-core rate (2 D N L = 2.75e11 operations, 0.139 ms against
// 0.08 ms for its 256 MiB), the dense one by its 1 GiB of int8 (0.33 ms).
// Design, q8_right2d_mma_kernel's (q8_right2d_kernels.cu) turned over:
//   - one block per 128 samples x 128 columns of the output, looping over
//     its range of rows in chunks of kQ8LChunk = 128 rows; two consumer
//     warpgroups, each owning 64 samples, issue wgmma m64n128k32.s32.s8.s8
//     with both operands K-major (the integer wgmma has no transposed
//     form), K = rows: A = G0^T, the decoded chunk stored [samples][rows]
//     with the 128-byte swizzle (128 rows = one swizzle row a sample), and
//     B = z8^T (L, D_pad), built on the card in the same C call
//     (transpose_z8_kernel, zero in every pad entry; in the q8 pass,
//     q8_pass.cuh, the requantization writes it and gp_q8_left2d_t takes
//     it ready-made) and read in 128-row x 128-column boxes by TMA with
//     the 128-byte swizzle;
//   - the transpose is the producer's: a loader warp's TMA loads bring
//     each chunk's raw rows (packed 32 bytes, dense 128 bytes a row) into
//     a raw ring, and a producer warp turns a whole chunk into its A slot:
//     16 rows x 16 samples a lane at a time, decoded to int8 dosages
//     (packed_g0_16 / dense_g0), 4 x 4 byte transposes by two rounds of
//     prmt, and one 16-byte store of 16 rows per sample.  Lane l takes the
//     16-row block l % 8, so the eight lanes of a store phase write eight
//     different swizzle chunks; it reads its rows rotated by that block
//     index, so that one load's lanes fall on different banks (the dense
//     ring also has the 128-byte swizzle), and rotates each sample's 16
//     bytes back before the store;
//   - the fold: the int32 accumulator holds one row tile.  Before the K
//     step (32 rows) that starts tile t + 1 the consumers wait for their
//     MMAs, add tot = tot + float(acc) sz[t] (__fmul_rn, __fadd_rn), and
//     restart the accumulator with scale-d 0; tile_d a multiple of 32, so
//     a K step never straddles tiles;
//   - TMA's zero fill decodes to dosage 2 in the packed layout: rows past
//     D meet zero columns of z8^T, and samples past N are never stored;
//   - where the sample blocks are fewer than the SMs (1-D widths, thin
//     strips) the rows split into grid.z ranges of whole row tiles
//     (q8_left2d_plan), each an f32 partial slab (splits, N, L) that
//     sum_splits_kernel adds in slab order.
// The plan is chosen here and reported by gp_q8_left2d_plan, so that the
// wrapper can size the workspace (z8^T, then the slab) and the plain
// version can fold its ranges in the same order.
#include "hopper.cuh"

namespace gp {

constexpr int kQ8LChunk = 128;                   // rows of a chunk: one K row
constexpr int kQ8LSamples = 2 * kTileRows;       // samples of a block
constexpr int kQ8LPanel = kTileRows * kQ8LChunk; // 64 samples x 128 rows int8
constexpr int kQ8LABytes = 2 * kQ8LPanel;        // an A slot (16 KB)
constexpr int kQ8LBBytes = kMmaCols * kQ8LChunk; // 128 columns x 128 rows int8
constexpr int kQ8LStep = 32;                     // rows of one MMA (K step)
// Registers per thread after the hand-over: the consumers' int32
// accumulator and f32 total take 128; the producer's 16 rows x 16 samples
// in and out about 80.
constexpr int kQ8LConsumerRegs = 184, kQ8LProducerRegs = 120;
static_assert(128 * (2 * kQ8LConsumerRegs + kQ8LProducerRegs + kLoaderRegs) <= 65536,
              "the register file");

// Ring depths and the shared-memory layout (byte offsets from a 1024-byte
// aligned base).  Producer warp pw takes chunks pw, pw + 4, ...; the A and
// raw depths are multiples of the producer warps, so that a slot of
// either ring serves one warp, which waits for its rounds by parity in
// order.  Packed raw rows are small (4 KB a chunk): 8 A slots, which
// keep the producer warps ahead (4 A and 6-8 z8^T slots ran slower);
// dense ones take 16 KB: 4 raw and 4 A slots, and 6 of z8^T (4 ran
// slower).  The loader sends a chunk's raw rows kLead chunks ahead of its
// z8^T tile where the raw ring is the deeper.
template <class Rows>
struct Q8LeftSmem {
  static constexpr bool kPacked = Rows::kGroupBytes == 1;
  static constexpr int kAStages = kPacked ? 8 : 4;
  static constexpr int kBStages = kPacked ? 3 : 6;
  static constexpr int kRawStages = kPacked ? 8 : 4;
  static constexpr int kLead = kRawStages > kBStages ? kRawStages - kBStages : 0;
  static_assert(kAStages % kProducerWarps == 0 && kRawStages % kProducerWarps == 0,
                "a slot serves one producer warp");
  static constexpr int kRowBytes = kQ8LSamples / 4 * Rows::kGroupBytes;  // a raw row
  static constexpr int kRawBytes = kQ8LChunk * kRowBytes;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kAStages * kQ8LABytes;
  static constexpr int kRaw = kB + kBStages * kQ8LBBytes;
  static constexpr int kBar = kRaw + kRawStages * kRawBytes;
  static constexpr int kBytes = kBar + 2 * (kAStages + kBStages + kRawStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// The tensor maps of one launch: z8^T (L, D_pad) int8 and the genotype rows.
struct Q8LeftMaps {
  CUtensorMap b, rows;
};

// Transposes four rows of four bytes: a[i] byte p -> out[p] byte i.
__device__ __forceinline__ void transpose4x4(uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t& o0, uint32_t& o1,
                                             uint32_t& o2, uint32_t& o3) {
  const uint32_t t0 = prmt(a0, a1, 0x5140u), t1 = prmt(a0, a1, 0x7362u);
  const uint32_t t2 = prmt(a2, a3, 0x5140u), t3 = prmt(a2, a3, 0x7362u);
  o0 = prmt(t0, t2, 0x5410u);
  o1 = prmt(t0, t2, 0x7632u);
  o2 = prmt(t1, t3, 0x5410u);
  o3 = prmt(t1, t3, 0x7632u);
}

// Rows 4 g .. 4 g + 3 of a 16 x 16 block (v[i]: 16 samples of row 4 g +
// i, byte p of word k sample 4 k + p) into word g of each sample's 16 rows
// (t[s][g] byte i: row 4 g + i of sample s).
__device__ __forceinline__ void transpose_group(const uint4 (&v)[4], uint32_t (&t)[16][4],
                                                int g) {
  transpose4x4(v[0].x, v[1].x, v[2].x, v[3].x, t[0][g], t[1][g], t[2][g], t[3][g]);
  transpose4x4(v[0].y, v[1].y, v[2].y, v[3].y, t[4][g], t[5][g], t[6][g], t[7][g]);
  transpose4x4(v[0].z, v[1].z, v[2].z, v[3].z, t[8][g], t[9][g], t[10][g], t[11][g]);
  transpose4x4(v[0].w, v[1].w, v[2].w, v[3].w, t[12][g], t[13][g], t[14][g], t[15][g]);
}

// A chunk's A tile (128 samples x 128 rows, a 64-sample panel a consumer
// warpgroup, [sample][row] with the 128-byte swizzle) from its raw rows,
// one warp.  Lane l takes row block rb = l % 8 (rows 16 rb .. 16 rb + 15,
// swizzle chunk rb of each sample's row) and the 16-sample blocks l / 8
// and l / 8 + 4.  It loads its rows in the order 16 rb + (i + rb) % 16:
// one load's lanes then read rows in four (packed) or eight (dense) bank
// classes, where rows 16 apart would all share one; after the transposes
// byte j of a sample's 16 holds row (j + rb) % 16, so the 16 bytes rotate
// left by rb before the store.  Packed raw rows are 32 bytes (8 words of
// 16 samples), dense ones 128 bytes with the 128-byte swizzle.
template <class Rows>
__device__ __forceinline__ void transpose_chunk(const uint8_t* raw, uint8_t* tile,
                                                int lane) {
  constexpr bool kPacked = Rows::kGroupBytes == 1;
  const int rb = lane % 8;
  const int wsh = rb >> 2, bsh = 8 * (rb & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sb = lane / 8 + 4 * h;
    uint32_t t[16][4];  // t[s][g]: sample 16 sb + s, rows of group g (rotated)
    if constexpr (kPacked) {
      uint32_t x[16];  // row 16 rb + (i + rb) % 16, samples 16 sb .. + 15
#pragma unroll
      for (int i = 0; i < 16; ++i)
        x[i] = reinterpret_cast<const uint32_t*>(raw)[(16 * rb + ((i + rb) & 15)) * 8 + sb];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = packed_g0_16(x[4 * g + i]);
        transpose_group(v, t, g);
      }
    } else {
      // A group of four rows at a time: 16 words in, 16 out, so that the
      // 64 words of the block's result are the most the warp holds.
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * rb + ((4 * g + i + rb) & 15);
          v[i] = *reinterpret_cast<const uint4*>(raw + r * 128 + ((sb ^ (r & 7)) << 4));
          v[i] = make_uint4(dense_g0(v[i].x), dense_g0(v[i].y), dense_g0(v[i].z),
                            dense_g0(v[i].w));
        }
        transpose_group(v, t, g);
      }
    }
    uint8_t* dst = tile + (sb / 4) * kQ8LPanel;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      // rotl by rb bytes: a word first where rb >= 4, then 8 (rb % 4) bits.
      const uint32_t w0 = wsh ? t[s][3] : t[s][0], w1 = wsh ? t[s][0] : t[s][1];
      const uint32_t w2 = wsh ? t[s][1] : t[s][2], w3 = wsh ? t[s][2] : t[s][3];
      const int sr = 16 * (sb % 4) + s;
      *reinterpret_cast<uint4*>(dst + swz128(sr, rb)) =
          make_uint4(__funnelshift_l(w3, w0, bsh), __funnelshift_l(w0, w1, bsh),
                     __funnelshift_l(w1, w2, bsh), __funnelshift_l(w2, w3, bsh));
    }
  }
}

// tot += float(acc) * s, one rounding each (no contraction into an FMA).
__device__ __forceinline__ void fold_q8(float (&tot)[64], const int (&acc)[64], float s) {
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = __fadd_rn(tot[i], __fmul_rn(__int2float_rn(acc[i]), s));
}

// Writes a consumer warpgroup's 64 samples x 128 columns of tot into out
// (row stride L) at samples r0.., columns l0..; samples >= n and columns
// >= L are not written.
__device__ __forceinline__ void store_tot(float* __restrict__ out, const float (&tot)[64],
                                          int r0, int l0, int n, int L, int warp,
                                          int lane) {
  const int row = r0 + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row + 8 * h, col = l0 + 8 * j + 2 * (lane % 4) + e;
        if (r < n && col < L) out[(size_t)r * L + col] = tot[4 * j + 2 * h + e];
      }
}

// out[z] (N, L) = sum over the row tiles [z per, min(T, (z + 1) per)) of
// sz[t] G0_t^T z8_t, z = blockIdx.z, folded in tile order: the result when
// there is one range, else the slab of partials.
template <class Rows>
__global__ void __launch_bounds__(kMmaThreads, 1)
q8_left2d_mma_kernel(const __grid_constant__ Q8LeftMaps maps, const float* __restrict__ sz,
                     float* __restrict__ out, int D, int N, int L, int tile_d, int per) {
  using Smem = Q8LeftSmem<Rows>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Smem::kBar);
  const Ring<Smem::kAStages> a{bars};
  const Ring<Smem::kBStages> b{bars + 2 * Smem::kAStages};
  const Ring<Smem::kRawStages> raw{bars + 2 * (Smem::kAStages + Smem::kBStages)};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = blockIdx.x * kQ8LSamples, l0 = blockIdx.y * kMmaCols;
  const int n_tiles = (D + tile_d - 1) / tile_d;
  const int t0 = blockIdx.z * per;
  const int row0 = t0 * tile_d;
  const int row_end = min(D, min(n_tiles, t0 + per) * tile_d);
  const int chunks = max(0, (row_end - row0 + kQ8LChunk - 1) / kQ8LChunk);
  if (tid == 0) {
    a.init(1, 2);    // the producer warp of the chunk; both consumer warpgroups
    b.init(1, 2);    // the loader's arrival + the TMA bytes; both consumers
    raw.init(1, 1);  // the loader's arrival + the TMA bytes; the producer warp
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kLoaderWarp) {
    setmaxnreg_dec<kLoaderRegs>();
    if (warp != kLoaderWarp) return;
    // Loader: lane 0 issues every TMA load as soon as its slot is free,
    // the raw rows of chunk j and the z8^T tile of chunk j - kLead.
    if (lane == 0)
      load_in_turn(
          chunks, Smem::kLead,
          [&](int j) {
            raw.wait_empty(j);
            mbar_arrive_expect_tx(raw.full(j), Smem::kRawBytes);
            tma_load_2d(sm + Smem::kRaw + raw.slot(j) * Smem::kRawBytes, &maps.rows,
                        s0 / 4 * Rows::kGroupBytes, row0 + j * kQ8LChunk, raw.full(j));
          },
          [&](int j) {
            b.wait_empty(j);
            mbar_arrive_expect_tx(b.full(j), kQ8LBBytes);
            tma_load_2d(sm + Smem::kB + b.slot(j) * kQ8LBBytes, &maps.b,
                        row0 + j * kQ8LChunk, l0, b.full(j));
          });
  } else if (warp >= 8) {
    setmaxnreg_dec<kQ8LProducerRegs>();
    // Producer warp pw: chunks pw, pw + 4, ..., each once its raw rows have
    // landed and its A slot is free; then it hands the A slot to the
    // consumers and the raw slot back.
    for (int it = warp - 8; it < chunks; it += kProducerWarps) {
      raw.wait_full(it);
      a.wait_empty(it);
      transpose_chunk<Rows>(sm + Smem::kRaw + raw.slot(it) * Smem::kRawBytes,
                            sm + Smem::kA + a.slot(it) * kQ8LABytes, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        raw.release(it);
        mbar_arrive(a.full(it));
      }
    }
  } else {
    setmaxnreg_inc<kQ8LConsumerRegs>();
    // Consumers: warpgroup wg owns samples s0 + 64 wg .. + 63.  `bound` is
    // the first row past the tile the accumulator holds.
    const int wg = warp / 4;
    int acc[64];
    float tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0, tot[i] = 0.f;
    int t = t0, bound = row0 + tile_d;
    bool fresh = true;
    for (int c = 0; c < chunks; ++c) {
      a.wait_full(c);
      b.wait_full(c);
      const uint32_t at = smem_u32(sm + Smem::kA + a.slot(c) * kQ8LABytes + wg * kQ8LPanel);
      const uint32_t bt = smem_u32(sm + Smem::kB + b.slot(c) * kQ8LBBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ8LChunk / kQ8LStep; ++kk) {
        const int r = row0 + c * kQ8LChunk + kQ8LStep * kk;
        if (r < row_end) {
          if (r == bound) {  // tile t is complete: fold it, restart
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            fold_q8(tot, acc, __ldg(sz + t));
            ++t;
            bound += tile_d;
            fresh = true;
            wgmma_fence();
          }
          wgmma_m64n128k32_s8(acc, desc_b128(at + 32 * kk, 16, 1024),
                              desc_b128(bt + 32 * kk, 16, 1024), fresh ? 0 : 1);
          fresh = false;
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // chunk c - 1's MMAs are done: release its slots
      if (c > 0 && tid % 128 == 0) {
        a.release(c - 1);
        b.release(c - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (!fresh) fold_q8(tot, acc, __ldg(sz + t));
    store_tot(out + (size_t)blockIdx.z * N * L, tot, s0 + kTileRows * wg, l0, N, L, warp,
              lane);
  }
}

// dst (lp, dp) = src^T of src (D, L) int8 row-major, zero in every entry
// past D or L: 64 x 64 tiles through shared memory, bytes in, words out.
// Builds z8^T here and, in the q8 pass (q8_pass.cuh), bq^T.
__global__ void __launch_bounds__(256)
transpose_z8_kernel(const int8_t* __restrict__ z8, int8_t* __restrict__ z8t, int D,
                    int L, int dp, int lp) {
  __shared__ uint32_t tile[64][17];  // tile[l][d / 4], bytes of d
  uint8_t* tb = reinterpret_cast<uint8_t*>(&tile[0][0]);
  const int d0 = blockIdx.x * 64, l0 = blockIdx.y * 64;
  for (int e = threadIdx.x; e < 64 * 64; e += 256) {
    const int dr = e / 64, lc = e % 64, d = d0 + dr, l = l0 + lc;
    tb[lc * 68 + dr] = (d < D && l < L) ? (uint8_t)z8[(size_t)d * L + l] : 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 16; e += 256) {
    const int lr = e / 16, wc = e % 16, l = l0 + lr, d = d0 + 4 * wc;
    if (l < lp && d < dp)
      *reinterpret_cast<uint32_t*>(z8t + (size_t)l * dp + d) = tile[lr][wc];
  }
}

// dp a multiple of 4 (a word of the output), dst 4-byte aligned.
inline int launch_transpose_i8(const int8_t* src, int8_t* dst, int D, int L, int dp,
                               int lp, cudaStream_t st) {
  transpose_z8_kernel<<<dim3((dp + 63) / 64, (lp + 63) / 64), 256, 0, st>>>(src, dst, D, L,
                                                                          dp, lp);
  return (int)cudaGetLastError();
}

// The launch of q8_left2d_mma_kernel over D rows of N samples and L
// columns on `sms` SMs: a block per kQ8LSamples x kMmaCols output tile,
// and the T = ceil(D / tile_d) row tiles split into grid.z ranges of `per`
// tiles where those blocks are fewer than the SMs, about as many ranges as
// SMs per block (rounded: 1 at 128 blocks, 2 at 88, 8 at 16).
struct Q8LeftPlan {
  dim3 grid;
  int per;
  long long z8t_bytes, work_bytes;
};

inline long long pad16(long long x) { return (x + 15) / 16 * 16; }

inline Q8LeftPlan q8_left2d_plan(int D, int N, int L, int tile_d, int sms) {
  const int samples = (N + kQ8LSamples - 1) / kQ8LSamples;
  const int cols = (L + kMmaCols - 1) / kMmaCols;
  const int tiles = std::max(1, samples * cols);
  const int n_tiles = std::max(1, (D + tile_d - 1) / std::max(1, tile_d));
  int ranges = 1;
  if (tiles < sms) ranges = std::max(1, std::min(n_tiles, (2 * sms + tiles) / (2 * tiles)));
  const int per = (n_tiles + ranges - 1) / ranges;
  ranges = (n_tiles + per - 1) / per;
  const long long z8t = (pad16(L) * pad16(D) + 255) / 256 * 256;
  const long long slab = ranges > 1 ? 4ll * ranges * N * L : 0;
  return {dim3(samples, cols, ranges), per, z8t, z8t + slab};
}

// Rows of 4 * groups samples: packed bytes in boxes of a block's 32 bytes
// x 128 rows; dense int8 rows in 128-sample x 128-row boxes with the
// 128-byte swizzle.
inline int q8_left_rows_map(CUtensorMap* map, PackedRows g, int D) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.p, g.groups, D,
                    kQ8LSamples / 4, kQ8LChunk, CU_TENSOR_MAP_SWIZZLE_NONE);
}

inline int q8_left_rows_map(CUtensorMap* map, DenseRows g, int D) {
  return i8_map(map, g.p, 4 * g.groups, D, kQ8LChunk);
}

// z8t (pad16(L), pad16(D)) int8 = z8^T as q8_left_operand states it, sz
// (T,) f32, out (N, L) f32; slab (ranges, N, L) f32 where the plan splits
// the rows (else unused).  tile_d must be a multiple of kQ8LStep.
template <class Rows>
int launch_q8_left2d_t(Rows g, const int8_t* z8t, const void* sz, float* out, float* slab,
                       int D, int L, int tile_d, int sms, cudaStream_t st) {
  if (tile_d <= 0 || tile_d % kQ8LStep) return (int)cudaErrorInvalidValue;
  const int N = 4 * g.groups;
  if (D <= 0 || L <= 0 || N <= 0) return 0;
  const Q8LeftPlan p = q8_left2d_plan(D, N, L, tile_d, sms);
  const int splits = (int)p.grid.z;
  if (splits > 1 && slab == nullptr) return (int)cudaErrorInvalidValue;
  Q8LeftMaps maps;
  memset(&maps, 0, sizeof(maps));
  int rc = i8_map(&maps.b, z8t, (int)pad16(D), L, kMmaCols);
  if (rc == 0) rc = q8_left_rows_map(&maps.rows, g, D);
  if (rc != 0) return rc;
  constexpr int smem = Q8LeftSmem<Rows>::kBytes;
  static OncePerDevice once;
  rc = allow_smem(once, q8_left2d_mma_kernel<Rows>, smem);
  if (rc != 0) return rc;
  q8_left2d_mma_kernel<Rows><<<p.grid, kMmaThreads, smem, st>>>(
      maps, (const float*)sz, splits > 1 ? slab : out, D, N, L, tile_d, p.per);
  rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  return launch_sum_splits(static_cast<const float*>(slab), out, N, L, L, splits, sms, st);
}

// z8 (D, L) int8, sz (T,) f32, out (N, L) f32; work: z8^T then the slab,
// of the plan's bytes.  tile_d must be a multiple of kQ8LStep.
template <class Rows>
int launch_q8_left2d(Rows g, const void* z8, const void* sz, float* out, void* work,
                     int D, int L, int tile_d, int sms, void* stream) {
  if (tile_d <= 0 || tile_d % kQ8LStep) return (int)cudaErrorInvalidValue;
  const int N = 4 * g.groups;
  if (D <= 0 || L <= 0 || N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Q8LeftPlan p = q8_left2d_plan(D, N, L, tile_d, sms);
  int8_t* z8t = static_cast<int8_t*>(work);
  float* slab = reinterpret_cast<float*>(static_cast<uint8_t*>(work) + p.z8t_bytes);
  const int rc = launch_transpose_i8((const int8_t*)z8, z8t, D, L, (int)pad16(D),
                                     (int)pad16(L), st);
  if (rc != 0) return rc;
  return launch_q8_left2d_t(g, z8t, sz, out, p.grid.z > 1 ? slab : nullptr, D, L, tile_d,
                            sms, st);
}

}  // namespace gp

extern "C" {

// out (4 n4, L) f32 = sum_t sz[t] G0_t^T z8_t over packed rows of n4 bytes /
// dense rows of n4 words; z8 (D, L) int8, sz (ceil(D / tile_d),) f32,
// tile_d a multiple of 32; work of gp_q8_left2d_plan's bytes (z8^T, then
// the slab of the row ranges).
int gp_q8_left2d(const void* packed, const void* z8, const void* sz, void* out,
                 void* work, int D, int n4, int L, int tile_d, int sms, void* stream) {
  return gp::launch_q8_left2d(gp::PackedRows{(const uint8_t*)packed, n4}, z8, sz,
                              (float*)out, work, D, L, tile_d, sms, stream);
}

int gp_q8_left2d_dense(const void* geno, const void* z8, const void* sz, void* out,
                       void* work, int D, int n4, int L, int tile_d, int sms,
                       void* stream) {
  return gp::launch_q8_left2d(gp::DenseRows{(const int8_t*)geno, n4}, z8, sz,
                              (float*)out, work, D, L, tile_d, sms, stream);
}

// The same product over z8^T made ready (pad16(L), pad16(D)) int8 as
// q8_left_operand states it; slab (ranges, 4 n4, L) f32 where
// gp_q8_left2d_plan splits the rows, else unused.  The q8 pass's left step.
int gp_q8_left2d_t(const void* packed, const void* z8t, const void* sz, void* out,
                   void* slab, int D, int n4, int L, int tile_d, int sms, void* stream) {
  return gp::launch_q8_left2d_t(gp::PackedRows{(const uint8_t*)packed, n4},
                                (const int8_t*)z8t, sz, (float*)out, (float*)slab, D, L,
                                tile_d, sms, (cudaStream_t)stream);
}

int gp_q8_left2d_t_dense(const void* geno, const void* z8t, const void* sz, void* out,
                         void* slab, int D, int n4, int L, int tile_d, int sms,
                         void* stream) {
  return gp::launch_q8_left2d_t(gp::DenseRows{(const int8_t*)geno, n4},
                                (const int8_t*)z8t, sz, (float*)out, (float*)slab, D, L,
                                tile_d, sms, (cudaStream_t)stream);
}

// dst (lp, dp) int8 = src^T of src (rows, cols) int8, zero past rows or
// cols; dp a multiple of 4, dst 4-byte aligned.
int gp_transpose_i8(const void* src, void* dst, int rows, int cols, int dp, int lp,
                    void* stream) {
  return gp::launch_transpose_i8((const int8_t*)src, (int8_t*)dst, rows, cols, dp, lp,
                                 (cudaStream_t)stream);
}

// The tile (samples, columns), grid (x, y), row ranges (grid z), row tiles
// a range and workspace bytes (z8^T, then the slab) of the q8 left product
// over D rows, N samples, L columns and row tiles of tile_d on `sms` SMs,
// as launch_q8_left2d launches it, into plan[0..6].
int gp_q8_left2d_plan(int D, int N, int L, int tile_d, int sms, long long* plan) {
  const gp::Q8LeftPlan p = gp::q8_left2d_plan(D, N, L, tile_d, sms);
  plan[0] = gp::kQ8LSamples;
  plan[1] = gp::kMmaCols;
  plan[2] = p.grid.x;
  plan[3] = p.grid.y;
  plan[4] = p.grid.z;
  plan[5] = p.per;
  plan[6] = p.work_bytes;
  return 0;
}

}  // extern "C"
