// linear's 16-row blocks (1 x 2 warps of 16 rows), compiled beside
// linear.cu so that the instances build in parallel (csrc/linear.cu has the
// design, csrc/linear_tile.cuh the tile).
#include "linear_tile.cuh"

namespace EVT_INSTANCE {

int linear_rows16(EVT_LINEAR_ARGS) {
  return launch_cols<1, 16>(x, w, bias, res, y, M, N, K, epi, cols, va, vb, s);
}

}  // namespace EVT_INSTANCE
