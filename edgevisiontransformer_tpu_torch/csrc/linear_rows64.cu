// linear's 64-row blocks (2 x 2 warps of 32 rows), compiled beside
// linear.cu so that the instances build in parallel (csrc/linear.cu has the
// design, csrc/linear_tile.cuh the tile).
#include "linear_tile.cuh"

int linear_rows64(EVT_LINEAR_ARGS) {
  return launch_cols<2, 32>(x, w, bias, res, y, M, N, K, epi, cols, va, vb, s);
}
