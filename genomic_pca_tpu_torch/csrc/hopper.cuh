// Hopper building blocks of the tensor-core genotype kernels, and the
// producer decode that turns genotype bytes into their bf16 MMA operand.
//
//   - mbarriers (init, arrive, arrive with a byte count, parity wait),
//     1-D and 2-D TMA loads, the generic-to-async proxy fence;
//   - wgmma: the B128 shared-memory matrix descriptor and
//     m64n128k16.f32.bf16.bf16 with both operands MN-major;
//   - decode_rows<Rows>: 16 rows of raw genotype groups -> bf16 rows of a
//     (64 rows x 128 samples) operand tile.
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
#include <string.h>

#include "packed_common.cuh"

namespace gp {

constexpr int kTileRows = 64;                  // variant rows (K) of a tile
constexpr int kTileSamples = 128;              // samples of a tile: 2 panels
constexpr int kPanelBytes = kTileRows * 128;   // 64 rows x 64 bf16
constexpr int kTileBytes = 2 * kPanelBytes;

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

// d (64 x 128 f32, the warpgroup's fragment) = A (64 x 16) B (16 x 128)
// (+ d when scale_d), A and B bf16 in shared memory, both MN-major.
// Fragment: d[4j + 2h + e] is row 16 warp + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e of the warp's warpgroup tile.
__device__ __forceinline__ void wgmma_m64n128k16_tt(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
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
      " %64, %65, p, 1, 1, 1, 1;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
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

// Tile rows r0..r0+15 (r0 a multiple of 8) from a raw ring slot
// holding the tile's 32 groups of each row (row r at raw + r * 32 *
// kGroupBytes) and each row's mean and inv_std (smean[r], sinv[r]), one
// warp: lane j turns group j of a row into samples 4j..4j+3 and stores
// them as 8 bytes.  Values are the reference's bf16 tile: x = bf16(bf16(g
// sc) + sh), sc = bf16(inv_std), sh = bf16(-mean inv_std), missing -> 0;
// rows past the matrix arrive zero-filled (bytes and moments) and give 0.
//
//   PackedRows: dosages {0, 1, 2} make g sc exact, so a row takes three
//     values and 0.  Lane r of the warp computes them for its row; then
//     `tbl` (16 x 16 words of this warp) gets, per row, the bf16 pair of
//     each nibble (two 2-bit codes), one prmt each; a byte is then two
//     table reads.
//   DenseRows: any int8 dosage, so arithmetic: four bytes to f32 by the
//     2^23 magic bias, packed to two bf16x2 words (exact), then a bf16x2
//     multiply and add - two roundings, as the reference's dense tile
//     rounds - and the -127 sentinel masked.
template <class Rows>
__device__ __forceinline__ void decode_rows(const uint8_t* raw,
                                            const float* smean,
                                            const float* sinv, uint8_t* tile,
                                            uint32_t* tbl, int r0, int lane) {
  constexpr int kRows = 16;
  constexpr int kRowBytes = 32 * Rows::kGroupBytes;
  const RowScale own = row_scale(smean, sinv, r0 + lane % kRows, true);
  // Where lane's 8 bytes go in every row: panel, chunk (before the
  // swizzle, which XORs it with r % 8 = rr % 8) and half of the chunk.
  uint8_t* dst = tile + (lane >> 4) * kPanelBytes + r0 * 128 + ((lane & 1) << 3);
  const int chunk = (lane >> 1) & 7;
  // Every load of the rows is issued before the first store: the
  // stores go through pointers that may alias the loads, so a store in
  // between would serialise the rows on the shared-memory latency.
  uint32_t in[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
    in[rr] = Rows::kGroupBytes == 1
                 ? raw[(r0 + rr) * kRowBytes + lane]
                 : *reinterpret_cast<const uint32_t*>(raw + (r0 + rr) * kRowBytes + 4 * lane);
  uint2 out[kRows];
  if constexpr (Rows::kGroupBytes == 1) {
    // Codes {0, 1, 2, 3} = dosage {2, missing, 1, 0}: v01 holds the bf16
    // values of codes 0 and 1, v23 those of codes 2 and 3.
    const uint32_t v01 = bf16_bits(standardized<PackedRows>(0u, 0, own, true));
    const uint32_t v23 = bf16_bits(standardized<PackedRows>(2u, 0, own, true)) |
                         (bf16_bits(standardized<PackedRows>(3u, 0, own, true)) << 16);
    // prmt selector of this lane's nibble: bytes 2c, 2c + 1 of {v01, v23}
    // for each of its two codes c.
    const int nib = lane & 15;
    const uint32_t sel = 0x1010u + (nib & 3) * 0x22u + (nib >> 2) * 0x2200u;
    __syncwarp();  // the last chunk's table reads are done
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const int rr = 2 * i + (lane >> 4);
      tbl[rr * 16 + nib] = __byte_perm(__shfl_sync(0xffffffffu, v01, rr),
                                       __shfl_sync(0xffffffffu, v23, rr), sel);
    }
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      out[rr] = make_uint2(tbl[rr * 16 + (in[rr] & 15)], tbl[rr * 16 + (in[rr] >> 4)]);
  } else {
    const uint32_t sc2 = bf16x2_bits(__float2bfloat162_rn(own.sc));
    const uint32_t sh2 = bf16x2_bits(__float2bfloat162_rn(own.sh));
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const uint32_t sc = __shfl_sync(0xffffffffu, sc2, rr);
      const uint32_t sh = __shfl_sync(0xffffffffu, sh2, rr);
      const uint32_t w = in[rr];
      const uint32_t u = w ^ 0x80808080u;  // byte + 128, unsigned
      // bits 0x4B0000xx = 2^23 + xx: minus 2^23 + 128 is the signed dosage.
      const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
      const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
      const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
      const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
      const uint32_t lo = add_bf16x2(mul_bf16x2(bf16x2_bits(__floats2bfloat162_rn(f0, f1)), sc), sh);
      const uint32_t hi = add_bf16x2(mul_bf16x2(bf16x2_bits(__floats2bfloat162_rn(f2, f3)), sc), sh);
      // Bit 7 of each byte of `kept` is set where the byte is not -127;
      // prmt's sign-replicating selectors spread it over the bf16 lane.
      const uint32_t x = w ^ 0x81818181u;
      const uint32_t kept = ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
      out[rr] = make_uint2(lo & prmt(kept, 0u, 0x9988u), hi & prmt(kept, 0u, 0xBBAAu));
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
    *reinterpret_cast<uint2*>(dst + swz128(rr, chunk)) = out[rr];
}

}  // namespace gp
