// The second pass shared by the port's kernels: per-block partials folded
// in block order.
//
// On the TPU a sequential grid carried the accumulators from one tile to
// the next. Hopper blocks run in parallel and in no order, so each block
// writes its partials to scratch ([nchunks, per_chunk] f32) and this kernel
// sums them in index order: a fixed fold order, no float atomics, the same
// answer on every run.

#pragma once

#include <cuda_runtime.h>

// out[i] = sum over chunks k, in index order, of scratch[k, i]
static __global__ void fold_chunks(const float* scratch, float* out,
                                   int nchunks, int per_chunk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_chunk) return;
  float s = 0.f;
  for (int k = 0; k < nchunks; ++k) s = s + scratch[(size_t)k * per_chunk + i];
  out[i] = s;
}

static inline cudaError_t launch_fold(const float* scratch, float* out,
                                      int nchunks, int per_chunk,
                                      cudaStream_t stream) {
  fold_chunks<<<(per_chunk + 255) / 256, 256, 0, stream>>>(scratch, out,
                                                           nchunks, per_chunk);
  return cudaGetLastError();
}
