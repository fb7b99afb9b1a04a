// A measurement, not a kernel of the model: `n` launches of an empty kernel
// on a (gx, gy) grid of (bx, by) blocks, to read what a stream of launches
// costs before it does any work (cice_tpu_torch/tune_kernels.py times it
// on the grid of K1's `stream` route). Returns the last CUDA error.

#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int empty_launches(int gx, int gy, int bx, int by, int n,
                              void* stream) {
  for (int it = 0; it < n; ++it)
    empty_kernel<<<dim3(gx, gy), dim3(bx, by), 0,
                   static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
