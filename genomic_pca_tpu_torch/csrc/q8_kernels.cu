// Quantised (q8) steering pass on the packed layout: the two kernels of
// packed_common.cuh (q8_w_kernel, q8_left_kernel) instantiated for the
// PLINK 2-bit layout; the four samples of one byte decode to the four
// int8 lanes of a __dp4a word.
#include "packed_common.cuh"

extern "C" {

int gp_q8_w(const void* packed, const void* inv_std, const void* u,
            const void* bq, const void* sb, const void* csum, void* z,
            void* tile_max, void* ru, int D, int n4, int L, int tile_d,
            void* stream) {
  return gp::launch_q8_w(gp::PackedRows{(const uint8_t*)packed, n4}, inv_std,
                         u, bq, sb, csum, z, tile_max, ru, D, L, tile_d,
                         stream);
}

int gp_q8_left(const void* packed, const void* z, const void* tile_max,
               void* out, int D, int n4, int L, int tile_d, int splits,
               int tiles_per_split, void* stream) {
  return gp::launch_q8_left(gp::PackedRows{(const uint8_t*)packed, n4}, z,
                            tile_max, out, D, L, tile_d, splits,
                            tiles_per_split, stream);
}

}  // extern "C"
