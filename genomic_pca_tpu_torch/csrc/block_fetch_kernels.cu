// The standardized block batch of EigenSNP stages 1-2, both genotype
// layouts: standardize_runs_kernel.  It replaces no Pallas kernel: it is the
// port's counterpart of the XLA slicers `_slice_blocks_packed_impl` and
// `_slice_blocks_impl` (genomic_pca_tpu/parallel/sharded.py:305-376), which
// the reference's `fetch_blocks_device` jits.
//
// out (B, bucket, N) f32: row i of block b is the standardized matrix row
// runs[b] + i for i < runs[B + b] (its length), in original sample order,
// and 0 beyond; missing genotypes, rows of inv_std = 0 and blocks of
// length 0 (batch padding) are 0.  Each value is g * inv_std + (-mean *
// inv_std), the multiply and the add rounded apart (`standardized`,
// packed_common.cuh): the bits of the plain version's f32 chain.
//
// Bound on an H100 by bytes: at the UK Biobank chunk (1, 512, 407,552) it
// writes 834.7 MB and reads the run's rows (5.7 MB packed for 56 rows),
// 0.251 ms at 3.35 TB/s, against no arithmetic to speak of.  So each byte
// moves once:
//   - one block is one output row and 1,024 groups of it (4,096 samples);
//     a thread owns four groups, one in each of four passes, so that every
//     store of a warp is 32 neighbouring float4 (512 contiguous bytes);
//   - packed rows whose width is a multiple of 4 bytes come in one 32-bit
//     load a thread (16 samples); the warp hands each lane its byte of a
//     pass with a shuffle, so the codes are decoded in registers; other
//     widths, and dense rows (one 32-bit word a group), load a group a pass;
//   - each row's scale and shift are read once a thread;
//   - rows past a run are stored as zeros without reading the matrix;
//   - no intermediate in device memory.
#include "packed_common.cuh"

namespace gp {

constexpr int kRunThreads = 256;
constexpr int kRunPasses = 4;  // groups a thread
constexpr int kRunBlockGroups = kRunThreads * kRunPasses;

template <class Rows, bool kWord>
__global__ void __launch_bounds__(kRunThreads)
standardize_runs_kernel(Rows rows, const float* __restrict__ mean,
                        const float* __restrict__ inv_std,
                        const int* __restrict__ runs, int B, int bucket,
                        float4* __restrict__ out) {
  const int r = blockIdx.x;  // output row b * bucket + i
  const int b = r / bucket, i = r - b * bucket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = rows.groups;
  const int g0 = blockIdx.y * kRunBlockGroups + warp * 32 * kRunPasses;
  if (g0 >= G) return;  // the whole warp lies past the row
  float4* orow = out + (size_t)r * G;
  if (i >= runs[B + b]) {
#pragma unroll
    for (int k = 0; k < kRunPasses; ++k) {
      const int j = g0 + 32 * k + lane;
      if (j < G) orow[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int d = runs[b] + i;
  const RowScale s = row_scale(mean, inv_std, d, false);
  uint32_t word = 0;
  if constexpr (kWord) {
    const int jw = g0 + 4 * lane;  // the first group of this lane's word
    if (jw < G)
      word = *reinterpret_cast<const uint32_t*>(rows.p + (size_t)d * G + jw);
  }
#pragma unroll
  for (int k = 0; k < kRunPasses; ++k) {
    const int j = g0 + 32 * k + lane;
    uint32_t grp;
    if constexpr (kWord) {
      // Group j is byte lane % 4 of the word of lane 8k + lane / 4.
      const uint32_t w = __shfl_sync(0xffffffffu, word, 8 * k + (lane >> 2));
      grp = (w >> (8 * (lane & 3))) & 0xffu;
    } else {
      grp = j < G ? rows.group(d, j) : Rows::kMissing;
    }
    if (j < G)
      orow[j] = make_float4(standardized<Rows>(grp, 0, s, false),
                            standardized<Rows>(grp, 1, s, false),
                            standardized<Rows>(grp, 2, s, false),
                            standardized<Rows>(grp, 3, s, false));
  }
}

template <class Rows, bool kWord>
int launch_runs(Rows rows, const void* mean, const void* inv_std,
                const void* runs, void* out, int B, int bucket, void* stream) {
  const dim3 grid(B * bucket, (rows.groups + kRunBlockGroups - 1) / kRunBlockGroups);
  if (grid.x == 0 || grid.y == 0) return 0;
  standardize_runs_kernel<Rows, kWord><<<grid, kRunThreads, 0, (cudaStream_t)stream>>>(
      rows, (const float*)mean, (const float*)inv_std, (const int*)runs, B, bucket,
      (float4*)out);
  return (int)cudaGetLastError();
}

}  // namespace gp

extern "C" {

// out (B, bucket, 4 * n4) f32 of packed rows of n4 bytes; runs (2, B) int32:
// the local row starts, then the lengths.
int gp_standardize_runs_packed(const void* packed, const void* mean,
                               const void* inv_std, const void* runs, void* out,
                               int n4, int B, int bucket, void* stream) {
  const gp::PackedRows rows{(const uint8_t*)packed, n4};
  if (n4 % 4 == 0 && (uintptr_t)packed % 4 == 0)
    return gp::launch_runs<gp::PackedRows, true>(rows, mean, inv_std, runs, out, B,
                                                 bucket, stream);
  return gp::launch_runs<gp::PackedRows, false>(rows, mean, inv_std, runs, out, B,
                                                bucket, stream);
}

// The same over dense rows of n4 32-bit words (4 * n4 samples).
int gp_standardize_runs_dense(const void* geno, const void* mean,
                              const void* inv_std, const void* runs, void* out,
                              int n4, int B, int bucket, void* stream) {
  return gp::launch_runs<gp::DenseRows, false>(gp::DenseRows{(const int8_t*)geno, n4},
                                               mean, inv_std, runs, out, B, bucket,
                                               stream);
}

}  // extern "C"
