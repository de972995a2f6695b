// linear_i8's 64-row blocks (2 x 2 warps of 32 rows), compiled beside
// linear_i8.cu so that the instances build in parallel (csrc/linear_i8.cu has
// the design, csrc/linear_i8_tile.cuh the tile).
#include "linear_i8_tile.cuh"

namespace EVT_INSTANCE {

int linear_i8_rows64(EVT_LINEAR_I8_ARGS) {
  return launch_cols<2, 32>(q, s_row, w, w_s, bias, res, y, M, N, K, epi, bias_f32, cols,
                            split, va, vb, s);
}

}  // namespace EVT_INSTANCE
