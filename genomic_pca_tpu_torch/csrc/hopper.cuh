// Hopper building blocks of the tensor-core genotype kernels, and the
// producer decode that turns genotype bytes into their bf16 MMA operand.
//
//   - mbarriers (init, arrive, arrive with a byte count, parity wait),
//     rings of slots handed over by them, 1-D and 2-D TMA loads and their
//     tensor maps, the generic-to-async proxy fence;
//   - wgmma: the B128 shared-memory matrix descriptor,
//     m64n128k16.f32.bf16.bf16 with B MN-major and A MN-major (the left
//     product) or K-major (the right product), and m64n128k32.s32.s8.s8
//     with both operands K-major (the q8 right and left products);
//   - the warp roles both products share (consumers, producer, loader);
//   - decode_rows_with<Rows>: 16 rows of raw genotype groups -> bf16 rows
//     of a (64 rows x 128 samples) operand tile, from per-row codes built
//     by the caller (decode_rows: built per chunk by the warp itself).
//
// The operand tile.  Two panels of 64 samples (8 KB each, 1024-byte
// aligned); a panel row is 64 bf16 = 128 bytes, and its 16-byte chunk c
// lives at chunk c ^ (r % 8) of row r (the 128-byte swizzle, which TMA's
// SWIZZLE_128B writes too).  Read with the rows as the K axis, a panel is
// the canonical MN-major B128 operand of wgmma: 8-row groups 1024 bytes
// apart (the descriptor's SBO), panels of 64 along M or N apart by the LBO;
// that is how the left product A^T W reads A and W.  Read with the rows as
// the M axis, the same bytes are the K-major B128 operand of the right
// product A B.
#pragma once

#include <cuda.h>
#include <dlfcn.h>
#include <string.h>

#include <algorithm>
#include <atomic>

#include "packed_common.cuh"

namespace gp {

constexpr int kTileRows = 64;                  // variant rows of a tile
constexpr int kTileSamples = 128;              // samples of a tile: 2 panels
constexpr int kPanelBytes = kTileRows * 128;   // 64 rows x 64 bf16
constexpr int kTileBytes = 2 * kPanelBytes;
constexpr int kMmaCols = 128;                  // output columns of a block
// Both products fold their accumulator into a register total every kFold
// terms of the sum (rows of the left product, samples of the right), so
// that f32 rounding grows with K / kFold + kFold terms, not with K,
// whatever the tensor core's internal accumulation.
constexpr int kFold = 1024;

// The warp roles of a tensor-core block: consumer warpgroups 0 and 1 issue
// wgmma, warpgroup 2 decodes (kProducerWarps warps), warp 12 issues every
// TMA load and warps 13-15 leave at once (the loader's warpgroup is whole
// for setmaxnreg).  Registers per thread after the hand-over, the left
// product's split (the right product's moves 8 a consumer to the
// producer): the consumers' accumulator and total take 128, the
// producer's 16 rows in and out 48 (at 64 the packed decode spilled);
// 2 x 128 x 192 + 128 x (104 + 24) is the SM's 65,536.
constexpr int kMmaThreads = 512;
constexpr int kLoaderWarp = 12;
constexpr int kProducerWarps = 4;
constexpr int kWarpRows = 16;  // rows of one decode call
constexpr int kConsumerRegs = 192, kProducerRegs = 104, kLoaderRegs = 24;
static_assert(128 * (2 * kConsumerRegs + kProducerRegs + kLoaderRegs) <= 65536,
              "the register file");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a swizzled panel.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// --- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// A ring of kStages shared-memory slots, each handed over by a "full" and
// an "empty" mbarrier (2 kStages barriers from `bar`): use i of the ring
// takes slot i % kStages and waits for the parity of its round.  A parity
// wait cannot tell round r from round r - 2, so a ring's user must not run
// two rounds ahead of the releases; each kernel states why it cannot.
template <int kStages>
struct Ring {
  uint64_t* bar;
  __device__ __forceinline__ static int slot(int i) { return i % kStages; }
  __device__ __forceinline__ uint64_t* full(int i) const { return &bar[i % kStages]; }
  __device__ __forceinline__ uint64_t* empty(int i) const {
    return &bar[kStages + i % kStages];
  }
  // One thread, before the block's first barrier.
  __device__ __forceinline__ void init(int fills, int releases) const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar[s], fills);
      mbar_init(&bar[kStages + s], releases);
    }
  }
  __device__ __forceinline__ void wait_full(int i) const {
    mbar_wait(full(i), (i / kStages) & 1);
  }
  __device__ __forceinline__ void wait_empty(int i) const {
    mbar_wait(empty(i), ((i / kStages) & 1) ^ 1);
  }
  __device__ __forceinline__ void release(int i) const { mbar_arrive(empty(i)); }
};

// The loader's order over two rings fed by TMA: the raw rows of chunk j go
// out with the other ring's tile of chunk j - lead (lead >= 0), so that
// both run as far ahead as their depths allow.
template <class Raw, class Tile>
__device__ __forceinline__ void load_in_turn(int chunks, int lead, Raw raw,
                                             Tile tile) {
  for (int j = 0; j < chunks + lead; ++j) {
    if (j < chunks) raw(j);
    if (j >= lead) tile(j - lead);
  }
}

// Waits until all `threads` threads (whole warps) of named barrier `id`
// arrive; id 0 is __syncthreads'.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// --- TMA --------------------------------------------------------------------

// The box of a 1-D tensor map at element x into shared memory; its bytes
// count towards the barrier's transaction.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];"
      :: "r"(smem_u32(dst)), "l"(map), "r"(x), "r"(smem_u32(bar))
      : "memory");
}

// The box of a 2-D tensor map at element coordinates (x inner, y) into
// shared memory; its bytes count towards the barrier's transaction.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded
// (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_LAZY);
    if (h != nullptr) fn = (EncodeTiledFn)dlsym(h, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// A tensor map of a row-major (rows, cols) matrix of `esize`-byte
// elements in boxes of box_x x box_y; rows = 0 makes it a vector (rank 1).
// TMA needs 16-byte aligned bases and row strides; boxes past the matrix
// arrive as zeros.
inline int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int esize,
                      const void* base, int cols, int rows, int box_x,
                      int box_y, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_x, (cuuint32_t)box_y};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, rows > 0 ? 2 : 1, const_cast<void*>(base),
                            dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The maps of the raw genotype rows (D, row bytes) in boxes of one tile's
// 32 groups x 64 rows, and of a bf16 operand (rows, ld) in 64 x 64 boxes
// with the 128-byte swizzle (W of the left product, B of the right).
template <class Rows>
int rows_map(CUtensorMap* map, Rows g, int D) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.p,
                    g.groups * Rows::kGroupBytes, D, 32 * Rows::kGroupBytes,
                    kTileRows, CU_TENSOR_MAP_SWIZZLE_NONE);
}

inline int bf16_map(CUtensorMap* map, const void* base, int ld, int rows) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, ld, rows,
                    64, kTileRows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A row-major (rows, ld) int8 matrix in boxes of 128 columns (128 bytes,
// the widest box SWIZZLE_128B takes) x box_rows rows with the 128-byte
// swizzle: a box lands as box_rows / 8 swizzle atoms of 1024 bytes, the
// K-major B128 operand of the s8 wgmma (K along the 128 columns).
inline int i8_map(CUtensorMap* map, const void* base, int ld, int rows,
                  int box_rows) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, ld, rows, 128,
                    box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// --- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a B128-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_b128(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads of accumulator registers across a
// wgmma wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x 128 f32, the warpgroup's fragment) = A (64 x 16) B (16 x 128)
// (+ d when scale_d), A and B bf16 in shared memory, B MN-major, A
// MN-major (kTransA 1: M contiguous) or K-major (kTransA 0: K contiguous;
// a K step of 16 is then a 32-byte advance inside the 128-byte swizzle row).
// Fragment: d[4j + 2h + e] is row 16 warp + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e of the warp's warpgroup tile.
template <int kTransA>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA));
}

// d (64 x 128 s32) = A (64 x 32) B (32 x 128) (+ d when scale_d), A and B
// int8 in shared memory, both K-major (the only layout the integer wgmma
// takes): a 128-byte swizzle row holds 128 K values, so a K step of 32 is
// a 32-byte advance inside it, as a bf16 K step of 16.  Sums are exact in
// int32 in any order.  The fragment is wgmma_m64n128k16's.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Shared-memory matrix descriptor of an operand without swizzle (layout
// 0): core matrices of 8 rows x 16 bytes, rows 16 bytes apart; lbo the
// byte offset between the two core matrices along K, sbo between groups
// of 8 rows along M or N (the K-major "interleave" layout).
__device__ __forceinline__ uint64_t desc_plain(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 16 f32) = A (64 x 16) B (16 x 16) (+ d when scale_d): A bf16 in
// registers (the RS form), B bf16 K-major in shared memory.  A fragment
// of warp w of the warpgroup, lane = 4 r + q: a[0] row 16 w + r, K slots
// 2q, 2q + 1 (the lower K in the low half), a[1] row + 8 the same slots,
// a[2] row 16 w + r slots 2q + 8, 2q + 9, a[3] row + 8 those.  The
// accumulator: d[4j + 2h + e] is row 16 w + r + 8h, column 8j + 2q + e.
// A register it reads may not be rewritten before the wgmma completes.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Keeps registers live, and their reads unmoved, up to this point: an A
// fragment until the wgmma that reads it is known complete.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

__device__ __forceinline__ void fence_regs(float (&d)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global memory into shared memory by the bulk copy engine;
// they count towards the barrier's transaction.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// tot += acc once every MMA in flight has landed in acc.
__device__ __forceinline__ void fold(float (&acc)[64], float (&tot)[64]) {
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] += acc[i];
}

// Writes a consumer warpgroup's 64 x 128 result tot + acc into out (row
// stride L) at rows r0.., columns l0..; rows >= n_rows and columns >= L
// are not written.
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&tot)[64],
                                           const float (&acc)[64], int r0,
                                           int l0, int n_rows, int L, int warp,
                                           int lane) {
  const int row = r0 + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row + 8 * h, col = l0 + 8 * j + 2 * (lane % 4) + e;
        const int i = 4 * j + 2 * h + e;
        if (r < n_rows && col < L) out[(size_t)r * L + col] = tot[i] + acc[i];
      }
}

// store_tile into a bf16 out of row stride ldo (a multiple of 8, >= L):
// each total rounded once to nearest even (the rounding of the
// reference's w.astype(bf16)), zeros in columns L..ldo - 1 (the padded
// operand layout of the left product's W); columns >= ldo not written.
__device__ __forceinline__ void store_tile(__nv_bfloat16* __restrict__ out,
                                           const float (&tot)[64],
                                           const float (&acc)[64], int r0,
                                           int l0, int n_rows, int L, int ldo,
                                           int warp, int lane) {
  const int row = r0 + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // A column pair never straddles ldo: one 4-byte store.
      const int r = row + 8 * h, col = l0 + 8 * j + 2 * (lane % 4);
      const int i = 4 * j + 2 * h;
      if (r < n_rows && col < ldo)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ldo + col) =
            __floats2bfloat162_rn(col < L ? tot[i] + acc[i] : 0.f,
                                  col + 1 < L ? tot[i + 1] + acc[i + 1] : 0.f);
    }
}

// out (rows, ldo) = the sum of slab[0..splits) (each (rows, L), f32 or
// int32) taken in slab order in the slab's type, in columns < L, and 0
// past L; out is converted once, after the whole sum: a bf16 out rounded
// from f32, an f32 out from int32 (the q8 product's exact integers).  The
// fixed-order reduction of the products that split their contraction
// into ranges (no atomics: the same bits every launch).
__device__ __forceinline__ float sum_to_f32(float s) { return s; }
__device__ __forceinline__ float sum_to_f32(int s) { return __int2float_rn(s); }

template <class T, class S>
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const S* __restrict__ slab, T* __restrict__ out, int rows,
                  int L, int ldo, int splits) {
  const size_t n = (size_t)rows * L, total = (size_t)rows * ldo;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const size_t r = i / ldo;
    const int c = (int)(i - r * ldo);
    S s = 0;
    if (c < L) {
      const size_t k = r * L + c;
      s = slab[k];
      for (int z = 1; z < splits; ++z) s += slab[z * n + k];
    }
    if constexpr (sizeof(T) == 2) {
      out[i] = __float2bfloat16_rn(s);
    } else {
      out[i] = sum_to_f32(s);
    }
  }
}

template <class T, class S>
int launch_sum_splits(const S* slab, T* out, int rows, int L, int ldo,
                      int splits, int sms, cudaStream_t st) {
  const size_t total = (size_t)rows * ldo;
  const int blocks = (int)std::max<size_t>(
      1, std::min<size_t>((total + kThreads - 1) / kThreads, 4 * sms));
  sum_splits_kernel<T, S><<<blocks, kThreads, 0, st>>>(slab, out, rows, L, ldo,
                                                      splits);
  return (int)cudaGetLastError();
}

// cudaFuncSetAttribute(kernel, max dynamic shared memory, bytes) once per
// device for the kernel instance that owns `once` (a static of its
// launcher), not once a launch: the launch's host work stays small.
struct OncePerDevice {
  std::atomic<unsigned long long> done{0};
};

template <class Kernel>
int allow_smem(OncePerDevice& once, Kernel kernel, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit & once.done.load()) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) once.done.fetch_or(bit);
  return (int)e;
}

// --- registers -------------------------------------------------------------

// Sets the registers per thread of the warpgroup (all four warps execute
// it): warp-specialised roles hand registers to the consumers.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(N));
}

// --- the producer decode ----------------------------------------------------

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// prmt.b32 in its generic mode: a selector nibble with bit 3 set
// replicates the sign bit of the byte it selects.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// G0, the int8 dosage with missing -> 0, of four packed bytes (sample 4k
// + p in bits 2p..2p+1 of byte k): byte p of word k.  Two bytes at a time,
// their eight 2-bit codes are spread to the nibbles of a prmt selector
// over the dosages of codes {0, 1, 2, 3} = {2, 0, 1, 0} (0x00010002); a
// selector reads only its low 16 bits.
__device__ __forceinline__ uint4 packed_g0_16(uint32_t x) {
  uint32_t lo = x & 0xFFFFu, hi = x >> 16;
  lo = (lo | (lo << 8)) & 0x00FF00FFu;
  hi = (hi | (hi << 8)) & 0x00FF00FFu;
  lo = (lo | (lo << 4)) & 0x0F0F0F0Fu;
  hi = (hi | (hi << 4)) & 0x0F0F0F0Fu;
  lo = (lo | (lo << 2)) & 0x33333333u;
  hi = (hi | (hi << 2)) & 0x33333333u;
  constexpr uint32_t kDosage = 0x00010002u;
  return make_uint4(prmt(kDosage, 0u, lo), prmt(kDosage, 0u, lo >> 16),
                    prmt(kDosage, 0u, hi), prmt(kDosage, 0u, hi >> 16));
}

// max(g, 0) of four int8 lanes: prmt's sign-replicating selectors make
// 0xFF of every negative byte (the -127 sentinel among them).
__device__ __forceinline__ uint32_t dense_g0(uint32_t w) {
  return w & ~prmt(w, 0u, 0xBA98u);
}

// a * b and a + b on bf16 pairs, each rounded to nearest even once.
// Inline PTX: the compiler may contract __hmul2 and __hadd2 into one fma,
// which rounds once where the reference rounds twice.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The per-row codes of the decode, from a row's bf16-rounded scale and
// shift (row_scale with bf16 = true; rows past the matrix {0, 0}).
//   PackedRows: dosages {0, 1, 2} make g sc exact, so a row takes three
//     values and 0.  Codes {0, 1, 2, 3} = dosage {2, missing, 1, 0}:
//     v01 holds the bf16 values of codes 0 and 1, v23 those of codes 2
//     and 3; the code of nibble n (two 2-bit codes) is the bf16 pair of
//     its two codes, one prmt of {v01, v23} (nibble_sel), and a byte is
//     then two code reads.
//   DenseRows: the bf16x2 scale and shift pairs.
__device__ __forceinline__ uint2 packed_values(RowScale s) {
  return make_uint2(bf16_bits(standardized<PackedRows>(0u, 0, s, true)),
                    bf16_bits(standardized<PackedRows>(2u, 0, s, true)) |
                        (bf16_bits(standardized<PackedRows>(3u, 0, s, true)) << 16));
}

// prmt selector of nibble n: bytes 2c, 2c + 1 of {v01, v23} for each of
// its two codes c.
__device__ __forceinline__ uint32_t nibble_sel(int n) {
  return 0x1010u + (n & 3) * 0x22u + (n >> 2) * 0x2200u;
}

__device__ __forceinline__ uint2 dense_pairs(RowScale s) {
  return make_uint2(bf16x2_bits(__float2bfloat162_rn(s.sc)),
                    bf16x2_bits(__float2bfloat162_rn(s.sh)));
}

// The bf16 values of one packed byte (samples 4j..4j+3, codes c_p in bits
// 2p..2p+1) from its row's packed_values v: (samples 0 and 1, samples 2
// and 3), each pair one prmt of the 8 bytes {v01, v23} whose selector
// nibbles are 2 c, 2 c + 1 for each of its two codes.  The codes go one
// to a byte first, so that one multiply-add makes both selectors.
__device__ __forceinline__ uint2 packed_byte(uint32_t byte, uint2 v) {
  uint32_t t = (byte | (byte << 12)) & 0x000F000Fu;  // samples 0-1, 2-3
  t = (t | (t << 6)) & 0x03030303u;                 // code of sample p in byte p
  const uint32_t sel = t * 0x22u + 0x10101010u;
  return make_uint2(__byte_perm(v.x, v.y, sel), __byte_perm(v.x, v.y, sel >> 16));
}

// The bf16 values of one dense word (int8 samples 4j..4j+3 in bytes 0-3)
// from its row's dense_pairs p = (scale, shift): (samples 0 and 1,
// samples 2 and 3).  Any int8 dosage, so arithmetic: four bytes to f32 by
// the 2^23 magic bias, packed to two bf16x2 words (exact), then a bf16x2
// multiply and add - two roundings, as the reference's dense tile rounds
// - and the -127 sentinel masked.
__device__ __forceinline__ uint2 dense_word(uint32_t w, uint2 p) {
  const uint32_t u = w ^ 0x80808080u;  // byte + 128, unsigned
  // bits 0x4B0000xx = 2^23 + xx: minus 2^23 + 128 is the signed dosage.
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
  const uint32_t lo = add_bf16x2(mul_bf16x2(bf16x2_bits(__floats2bfloat162_rn(f0, f1)), p.x), p.y);
  const uint32_t hi = add_bf16x2(mul_bf16x2(bf16x2_bits(__floats2bfloat162_rn(f2, f3)), p.x), p.y);
  // Bit 7 of each byte of `kept` is set where the byte is not -127;
  // prmt's sign-replicating selectors spread it over the bf16 lane.
  const uint32_t x = w ^ 0x81818181u;
  const uint32_t kept = ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
  return make_uint2(lo & prmt(kept, 0u, 0x9988u), hi & prmt(kept, 0u, 0xBBAAu));
}

// Words of codes a row: 16 nibble pairs packed, the two pairs dense.
template <class Rows>
constexpr int kCodeWords = Rows::kGroupBytes == 1 ? 16 : 2;

// All codes of one row into dst[0 .. kCodeWords).
template <class Rows>
__device__ __forceinline__ void row_codes(RowScale s, uint32_t* dst) {
  if constexpr (Rows::kGroupBytes == 1) {
    const uint2 v = packed_values(s);
#pragma unroll
    for (int n = 0; n < 16; ++n) dst[n] = __byte_perm(v.x, v.y, nibble_sel(n));
  } else {
    const uint2 p = dense_pairs(s);
    dst[0] = p.x;
    dst[1] = p.y;
  }
}

// Codes already in shared memory (the right product builds its block's
// once): those of row r0 + rr at p + rr * kCodeWords.
template <class Rows>
struct SharedCodes {
  const uint32_t* p;
  __device__ __forceinline__ void ready() const {}
  __device__ __forceinline__ uint32_t nibble(int rr, uint32_t n) const {
    return p[rr * 16 + n];
  }
  __device__ __forceinline__ uint2 pairs(int rr) const {
    return *reinterpret_cast<const uint2*>(p + 2 * rr);
  }
};

// Codes the decoding warp builds for each chunk (the left product, whose
// rows change every chunk): lane r holds those of row r0 + r % 16 in
// registers; packed, ready() writes the 16 rows' nibble codes into the
// warp's table `tbl` (16 x 16 words), after the raw loads.
template <class Rows>
struct WarpCodes {
  uint32_t* tbl;
  uint2 own;  // packed_values / dense_pairs of the lane's row
  int lane;
  __device__ __forceinline__ WarpCodes(const float* smean, const float* sinv,
                                       uint32_t* tbl_, int r0, int lane_)
      : tbl(tbl_), lane(lane_) {
    const RowScale s = row_scale(smean, sinv, r0 + lane % kWarpRows, true);
    own = Rows::kGroupBytes == 1 ? packed_values(s) : dense_pairs(s);
  }
  __device__ __forceinline__ void ready() const {
    if constexpr (Rows::kGroupBytes == 1) {
      const int n = lane & 15;
      const uint32_t sel = nibble_sel(n);
      __syncwarp();  // the last chunk's table reads are done
#pragma unroll
      for (int i = 0; i < kWarpRows / 2; ++i) {
        const int rr = 2 * i + (lane >> 4);
        tbl[rr * 16 + n] = __byte_perm(__shfl_sync(0xffffffffu, own.x, rr),
                                       __shfl_sync(0xffffffffu, own.y, rr), sel);
      }
      __syncwarp();
    }
  }
  __device__ __forceinline__ uint32_t nibble(int rr, uint32_t n) const {
    return tbl[rr * 16 + n];
  }
  __device__ __forceinline__ uint2 pairs(int rr) const {
    return make_uint2(__shfl_sync(0xffffffffu, own.x, rr),
                      __shfl_sync(0xffffffffu, own.y, rr));
  }
};

// Tile rows r0..r0+15 (r0 a multiple of 8) from a raw ring slot holding
// the tile's 32 groups of each row (row r at raw + r * 32 * kGroupBytes),
// one warp: lane j turns group j of a row into samples 4j..4j+3 and stores
// them as 8 bytes.  Values are the reference's bf16 tile: x = bf16(bf16(g
// sc) + sh), sc = bf16(inv_std), sh = bf16(-mean inv_std), missing -> 0;
// rows past the matrix have zero codes and give 0.
//
//   PackedRows: two code reads a byte.
//   DenseRows: dense_word.
template <class Rows, class Codes>
__device__ __forceinline__ void decode_rows_with(const uint8_t* raw,
                                                 uint8_t* tile, int r0,
                                                 int lane, const Codes& codes) {
  constexpr int kRowBytes = 32 * Rows::kGroupBytes;
  // Where lane's 8 bytes go in every row: panel, chunk (before the
  // swizzle, which XORs it with r % 8 = rr % 8) and half of the chunk.
  uint8_t* dst = tile + (lane >> 4) * kPanelBytes + r0 * 128 + ((lane & 1) << 3);
  const int chunk = (lane >> 1) & 7;
  // Every load of the rows is issued before the first store: the
  // stores go through pointers that may alias the loads, so a store in
  // between would serialise the rows on the shared-memory latency.
  uint32_t in[kWarpRows];
#pragma unroll
  for (int rr = 0; rr < kWarpRows; ++rr)
    in[rr] = Rows::kGroupBytes == 1
                 ? raw[(r0 + rr) * kRowBytes + lane]
                 : *reinterpret_cast<const uint32_t*>(raw + (r0 + rr) * kRowBytes + 4 * lane);
  codes.ready();
  uint2 out[kWarpRows];
  if constexpr (Rows::kGroupBytes == 1) {
#pragma unroll
    for (int rr = 0; rr < kWarpRows; ++rr)
      out[rr] = make_uint2(codes.nibble(rr, in[rr] & 15), codes.nibble(rr, in[rr] >> 4));
  } else {
#pragma unroll
    for (int rr = 0; rr < kWarpRows; ++rr) out[rr] = dense_word(in[rr], codes.pairs(rr));
  }
#pragma unroll
  for (int rr = 0; rr < kWarpRows; ++rr)
    *reinterpret_cast<uint2*>(dst + swz128(rr, chunk)) = out[rr];
}

// decode_rows_with for the left product: the rows' codes from their mean
// and inv_std in the raw slot (smean[r], sinv[r]; zero-filled past the
// matrix), built by the warp for this chunk.
template <class Rows>
__device__ __forceinline__ void decode_rows(const uint8_t* raw,
                                            const float* smean,
                                            const float* sinv, uint8_t* tile,
                                            uint32_t* tbl, int r0, int lane) {
  decode_rows_with<Rows>(raw, tile, r0, lane,
                         WarpCodes<Rows>(smean, sinv, tbl, r0, lane));
}

}  // namespace gp
