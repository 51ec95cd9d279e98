// The quantized (q8) power pass, one C call of three steps (q8_pass.cuh):
// the s8 tensor-core right product, the requantization into z8^T, the s8
// tensor-core left product with its row split.  It replaces
//
//   fused_gram_q8_packed (genomic_pca_tpu/ops/pallas_kernels.py :977,
//        pallas_call :995; body _gram_q8_packed_kernel :950) -> gp_q8_pass_packed
//   fused_gram_q8 (:847, pallas_call :863; body _gram_q8_kernel :807)
//                                                         -> gp_q8_pass_dense
//
// and is the 2-D q8 pass (q8_power_pass_2d: kernels 7 and 8, or 7i and 8i)
// too, which computes the same function.
#include "q8_pass.cuh"

extern "C" {

// out (4 n4, L) f32, ru (L) f32 over packed rows of n4 bytes; bq (nb, L)
// int8, nb <= 4 n4; `work` as gp_q8_pass_plan sizes it.
int gp_q8_pass_packed(const void* packed, const void* inv_std, const void* u,
                      const void* bq, const void* sb, const void* csum, void* out,
                      void* ru, void* work, int D, int n4, int nb, int L, int tile_d,
                      int sms, void* stream) {
  return gp::launch_q8_pass(gp_q8_right2d, gp_q8_left2d_t, packed, inv_std, u, bq, sb,
                            csum, out, ru, work, D, n4, nb, L, tile_d, sms, stream);
}

// The same over dense int8 rows of n4 words (4 n4 samples).
int gp_q8_pass_dense(const void* geno, const void* inv_std, const void* u, const void* bq,
                     const void* sb, const void* csum, void* out, void* ru, void* work,
                     int D, int n4, int nb, int L, int tile_d, int sms, void* stream) {
  return gp::launch_q8_pass(gp_q8_right2d_dense, gp_q8_left2d_t_dense, geno, inv_std, u,
                            bq, sb, csum, out, ru, work, D, n4, nb, L, tile_d, sms, stream);
}

// The plans of the q8 pass over D rows of n4 groups (4 n4 samples), L
// columns and row tiles of tile_d on `sms` SMs, either layout, into
// plan[0..11]: the right product's tile (rows, columns), grid (x, y) and
// sample splits; the left product's tile (samples, columns), grid (x, y),
// row ranges and row tiles a range; the workspace's bytes.
int gp_q8_pass_plan(int D, int n4, int L, int tile_d, int sms, long long* plan) {
  const gp::Q8PassPlan p = gp::q8_pass_plan(D, n4, L, tile_d, sms);
  for (int i = 0; i < 5; ++i) plan[i] = p.right[i];
  for (int i = 0; i < 6; ++i) plan[5 + i] = p.left[i];
  plan[11] = (long long)p.bytes;
  return 0;
}

}  // extern "C"
