// Shared pieces of the banded-alignment kernels (banded_align.cu,
// banded_fwd_diag.cu, banded_tb.cu): the DP's constants and the best-end
// tie-break of the JAX package's kernel (shasta_tpu/ops/align_pallas.py).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace banded {

constexpr int kNegInf = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

// Best end: max score, then min packed row (2 * row, + 1 for an end on
// the last row rather than the last column), then min lane.
__device__ __forceinline__ bool better(int v1, int im1, int d1, int v2,
                                       int im2, int d2) {
  return v1 > v2 || (v1 == v2 && (im1 < im2 || (im1 == im2 && d1 < d2)));
}

// Folds the warp's (v, im, bd) into lane 0 with better().
__device__ __forceinline__ void warp_fold_best(int& v, int& im, int& bd) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v2 = __shfl_down_sync(kFull, v, o);
    const int im2 = __shfl_down_sync(kFull, im, o);
    const int d2 = __shfl_down_sync(kFull, bd, o);
    if (better(v2, im2, d2, v, im, bd)) {
      v = v2;
      im = im2;
      bd = d2;
    }
  }
}

}  // namespace banded
