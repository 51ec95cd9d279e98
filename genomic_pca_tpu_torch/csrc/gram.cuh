// The exact 1-D gram pass A^T (A B) and Rayleigh-Ritz tsq pass
// (A B)^T (A B) in bf16 mode, on the tensor cores: the entries
// gp_gram_packed / gp_tsq_packed (exact_kernels.cu) and gp_gram_dense /
// gp_tsq_dense (dense_kernels.cu) of kernels 2 / 3 and 10 / 12, and their
// plans gp_gram_plan / gp_tsq_plan.
//
// The TPU kernels (fused_gram_apply_packed, pallas_kernels.py :492, body
// _gram_packed_kernel :447; fused_gram_apply :144, body _gram_kernel :95;
// fused_tsq_packed :564, body _tsq_packed_kernel :472; fused_tsq :215,
// body _tsq_kernel :120) carry one accumulator ((N, L) or (L, L)) in VMEM
// through a sequential grid of row tiles, computing per tile w = x b,
// rounding it to bf16 and adding x^T w or w^T w.  On Hopper one fused
// kernel would need either the gram pass's whole accumulator in a block
// (2,048 x 128 f32 = 1 MiB) or W for every row in each block, so each pass
// is two products with W in device memory once, as bf16:
//   1. W = A B, right2d_mma_kernel in its bf16-out mode (right2d_kernels.cu:
//      gp_right2d_w_*), each f32 total rounded once to nearest even (the
//      reference's w.astype(bf16)), into (D, ldw), ldw = L padded to 8,
//      zeros in the pad: the operand layout the second product's TMA
//      reads.  Where its plan splits the samples, the f32 partials are
//      summed in a fixed order and rounded once, after the sum.  Both
//      passes use the same plan, so their W are the same bits.
//   2. gram: A^T W, left2d_mma_kernel (wide_kernels.cu: gp_left2d_*), whose
//      plan splits the rows into ranges of whole folds at narrow widths;
//      tsq: W^T W, wtw_mma_kernel (wtw_kernels.cu: gp_wtw_mma), one block
//      per 128 x 128 output tile and range of whole folds.  Each range's
//      slab is summed in a fixed order.
// All launches go on the caller's stream; no atomics, so a second call
// gives the same bits.  Bound on an H100 at 262,144 x 2,048 x 128: gram,
// 4 D N L operations at the bf16 tensor-core rate, 0.278 ms; tsq, 2 D N L
// + 2 D L^2, 0.148 ms; W costs 2 D ldw bytes written and read (64 MiB,
// about 40 us at 3.35 TB/s).
//
// One workspace from the caller holds W (bf16 (D, ldw), from offset 0) and,
// after it, the larger of the right product's sample slab (splits, D, L)
// and the second product's row slab (gram (ranges, 4 n4, L), tsq
// (ranges, L, L)), all f32: the first is summed into W before the second
// product runs, so they share the bytes.  Each .cu compiles in its own
// nvcc process; these calls cross into right2d_kernels.cu,
// wide_kernels.cu and wtw_kernels.cu through their C entries.
#pragma once

#include <stddef.h>

extern "C" {
int gp_right2d_plan(int D, int N, int L, int sms, int* plan);
int gp_left2d_plan(int D, int n4, int L, int sms, int* plan);
int gp_right2d_w_packed(const void*, const void*, const void*, const void*, void*,
                        void*, int, int, int, int, int, int, int, void*);
int gp_right2d_w_dense(const void*, const void*, const void*, const void*, void*,
                       void*, int, int, int, int, int, int, int, void*);
int gp_left2d_packed(const void*, const void*, const void*, const void*, void*,
                     void*, int, int, int, int, int, int, void*);
int gp_left2d_dense(const void*, const void*, const void*, const void*, void*,
                    void*, int, int, int, int, int, int, void*);
int gp_wtw_plan(int D, int L, int sms, int* plan);
int gp_wtw_mma(const void*, void*, void*, int, int, int, int, void*);
}

namespace gp {

typedef int (*RightWEntry)(const void*, const void*, const void*, const void*,
                           void*, void*, int, int, int, int, int, int, int, void*);
typedef int (*LeftEntry)(const void*, const void*, const void*, const void*, void*,
                         void*, int, int, int, int, int, int, void*);

// The two products' plans (as gp_right2d_plan / gp_left2d_plan report
// them) and the workspace: W's bytes rounded up to 256, then the slab.
struct GramPlan {
  int right[5], left[5];
  int ldw;
  size_t w_bytes, slab_bytes;
};

inline GramPlan gram_plan(int D, int n4, int N, int L, int sms) {
  GramPlan p;
  gp_right2d_plan(D, N, L, sms, p.right);
  gp_left2d_plan(D, n4, L, sms, p.left);
  p.ldw = (L + 7) / 8 * 8;
  p.w_bytes = ((size_t)D * p.ldw * 2 + 255) / 256 * 256;
  const size_t right = p.right[4] > 1 ? (size_t)p.right[4] * D * L * 4 : 0;
  const size_t left = p.left[4] > 1 ? (size_t)p.left[4] * 4 * n4 * L * 4 : 0;
  p.slab_bytes = right > left ? right : left;
  return p;
}

// out (4 n4, L) f32 = A^T bf16(A B): b bf16 (N, ldb), columns >= L zero;
// `work` at least the plan's w_bytes + slab_bytes, 256-byte aligned.
inline int launch_gram(RightWEntry right, LeftEntry left, const void* geno,
                       const void* mean, const void* inv_std, const void* b,
                       void* out, void* work, int D, int n4, int N, int L,
                       int ldb, int sms, void* stream) {
  const GramPlan p = gram_plan(D, n4, N, L, sms);
  void* w = work;
  void* slab = p.slab_bytes ? (char*)work + p.w_bytes : nullptr;
  const int rc = right(geno, mean, inv_std, b, w, slab, D, n4, N, L, ldb, p.ldw,
                       sms, stream);
  if (rc != 0) return rc;
  return left(geno, mean, inv_std, w, out, slab, D, n4, L, p.ldw, 1, sms, stream);
}

// The tsq pass's plans: the gram pass's right product (the same W), then
// W^T W's tile, grid and row ranges; the workspace: W's bytes rounded up
// to 256, then the slab.
struct TsqPlan {
  int right[5], wtw[5];
  int ldw;
  size_t w_bytes, slab_bytes;
};

inline TsqPlan tsq_plan(int D, int N, int L, int sms) {
  TsqPlan p;
  gp_right2d_plan(D, N, L, sms, p.right);
  gp_wtw_plan(D, L, sms, p.wtw);
  p.ldw = (L + 7) / 8 * 8;
  p.w_bytes = ((size_t)D * p.ldw * 2 + 255) / 256 * 256;
  const size_t right = p.right[4] > 1 ? (size_t)p.right[4] * D * L * 4 : 0;
  const size_t wtw = p.wtw[4] > 1 ? (size_t)p.wtw[4] * L * L * 4 : 0;
  p.slab_bytes = right > wtw ? right : wtw;
  return p;
}

// out (L, L) f32 = bf16(A B)^T bf16(A B): b bf16 (N, ldb), columns >= L
// zero; `work` at least the plan's w_bytes + slab_bytes, 256-byte aligned.
inline int launch_tsq(RightWEntry right, const void* geno, const void* mean,
                      const void* inv_std, const void* b, void* out, void* work,
                      int D, int n4, int N, int L, int ldb, int sms, void* stream) {
  const TsqPlan p = tsq_plan(D, N, L, sms);
  void* w = work;
  void* slab = p.slab_bytes ? (char*)work + p.w_bytes : nullptr;
  const int rc = right(geno, mean, inv_std, b, w, slab, D, n4, N, L, ldb, p.ldw,
                       sms, stream);
  if (rc != 0) return rc;
  return gp_wtw_mma(w, out, slab, D, L, p.ldw, sms, stream);
}

}  // namespace gp
