// K3 on Hopper: the streaming roofline probe of the port's bench.
//
// Replaces bench.py::stream_probe (its pallas_call at bench.py:184): one
// pass over an [S, C] f32 value store. The TPU grid walked (512, C) tiles in
// order, summed each tile over its rows (all C columns, then the first 128
// kept) and added the sums into an (8, 128) VMEM accumulator, broadcast over
// its 8 rows. The last S % 512 rows belong to no tile and are never read.
// Every row of the (8, 128) output is therefore the column sums of the first
// floor(S / 512) * 512 rows over columns [0, 128).
//
// What bounds it: bytes. Every byte of every counted row is read once (the
// TPU kernel DMAs whole tiles, so this one does too). At bench.py's store,
// 2^20 x 768 f32, that is 3.22 GB, 0.961 ms at the H100 SXM data sheet's
// 3.35 TB/s; the one add per element takes 0.012 ms at 67 TFLOP/s f32.
//
// What the design does about it.
// Map pass: block b owns the whole 512-row tiles [b * tpb, (b + 1) * tpb), so
// block partials fall on the reference's tile boundaries. A thread owns 4
// adjacent columns: one 16-byte load a row where the row stride, the width
// and the base allow it (vec4), four scalar loads otherwise. Threads are
// (qx column quads) x (ry row groups); a row group strides the block's rows
// with kUnroll independent loads in flight and kUnroll accumulators, so about
// 24 KB of loads are outstanding per block at C = 768 (the card needs about
// 15 KB per SM to cover device-memory latency at full rate). The
// accumulators fold in a fixed order, then the row groups through shared
// memory, and the block writes its partial sums of ALL C columns to scratch
// [nblocks, C]: the write keeps every load live, and it is about 3 MB
// against the 3.2 GB read.
// Fold pass: one thread per output column sums the block partials in block
// order and writes the sum into all 8 rows. No float atomics, so every run
// gives the same bits. On integer-valued data below 2^24 every partial is
// exact, and kernel, plain version and reference agree bit for bit; on other
// data only the order of the f32 adds inside a tile differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 512;   // rows per tile (the reference's Sb)
constexpr int kThreads = 256;    // threads per map block, at most
constexpr int kUnroll = 8;       // loads in flight per thread
constexpr int kOutRows = 8;      // the (8, 128) output block
constexpr int kOutCols = 128;
constexpr int kFoldUnroll = 16;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Columns [c, c + 4) of one row; with Vec4 the caller guarantees c + 4 <=
// cols and 16-byte alignment, otherwise columns at or past cols read 0.
template <bool Vec4>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c,
                                        int cols) {
  if (Vec4) return __ldg(reinterpret_cast<const float4*>(row + c));
  float4 v;
  v.x = c < cols ? __ldg(row + c) : 0.f;
  v.y = c + 1 < cols ? __ldg(row + c + 1) : 0.f;
  v.z = c + 2 < cols ? __ldg(row + c + 2) : 0.f;
  v.w = c + 3 < cols ? __ldg(row + c + 3) : 0.f;
  return v;
}

// blockDim = (qx, ry); dynamic shared memory: ry * qx float4.
template <bool Vec4>
__global__ void __launch_bounds__(kThreads)
stream_map(const float* __restrict__ val, long long row_stride, int cols,
           int tiles, int tiles_per_block, float* __restrict__ scratch) {
  extern __shared__ float4 part[];
  const int qx = blockDim.x, ry = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(tiles, t0 + tiles_per_block);
  const long long r0 = (long long)t0 * kTileRows;
  const long long r1 = (long long)t1 * kTileRows;
  const int nq = (cols + 3) / 4;
  // ry divides 64, so kUnroll * ry divides the block's multiple of 512 rows
  // and the unrolled loop needs no remainder
  for (int qb = 0; qb < nq; qb += qx) {
    const int q = qb + tx;
    const int c = 4 * q;
    float4 acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < nq) {
      for (long long r = r0 + ty; r < r1; r += (long long)kUnroll * ry) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = load4<Vec4>(val + (r + (long long)u * ry) * row_stride, c,
                             cols);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[u] = add4(acc[u], v[u]);
      }
    }
    float4 s = acc[0];
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) s = add4(s, acc[u]);
    part[ty * qx + tx] = s;
    __syncthreads();
    if (ty == 0 && q < nq) {
      for (int g = 1; g < ry; ++g) s = add4(s, part[g * qx + tx]);
      float* dst = scratch + (size_t)blockIdx.x * cols + c;
      if (Vec4) {
        *reinterpret_cast<float4*>(dst) = s;
      } else {
        dst[0] = s.x;
        if (c + 1 < cols) dst[1] = s.y;
        if (c + 2 < cols) dst[2] = s.z;
        if (c + 3 < cols) dst[3] = s.w;
      }
    }
    __syncthreads();
  }
}

// out[r, c] = sum over blocks b, in block order, of scratch[b, c], for every
// r < 8 and c < 128. One block of kOutCols threads.
__global__ void stream_fold(const float* __restrict__ scratch, int nblocks,
                            int cols, float* __restrict__ out) {
  const int c = threadIdx.x;
  float s = 0.f;
  int b = 0;
  for (; b + kFoldUnroll <= nblocks; b += kFoldUnroll) {
    float v[kFoldUnroll];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u)
      v[u] = scratch[(size_t)(b + u) * cols + c];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) s = s + v[u];
  }
  for (; b < nblocks; ++b) s = s + scratch[(size_t)b * cols + c];
#pragma unroll
  for (int r = 0; r < kOutRows; ++r) out[r * kOutCols + c] = s;
}

}  // namespace

// val: [rows, cols] f32 with unit column stride and row_stride elements
// between rows; tiles_per_block and nblocks as ops/streamprobe.py's
// k3_launch_shape gives them (nblocks * tiles_per_block covers rows / 512
// tiles); vec4: 16-byte loads are aligned (cols and row_stride multiples of
// 4, val 16-byte aligned); scratch: [nblocks, cols] f32; out: [8, 128] f32.
// Returns cudaGetLastError() after each of its two launches.
extern "C" int streamprobe_launch(const float* val, long long row_stride,
                                  int rows, int cols, int tiles_per_block,
                                  int nblocks, int vec4, float* scratch,
                                  float* out, void* stream) {
  const int tiles = rows / kTileRows;
  if (cols < kOutCols || tiles < 1 || tiles_per_block < 1
      || (long long)nblocks * tiles_per_block < tiles
      || (long long)(nblocks - 1) * tiles_per_block >= tiles)
    return (int)cudaErrorInvalidValue;
  const int nq = (cols + 3) / 4;
  const int qx = nq > kThreads ? kThreads : (nq + 31) / 32 * 32;
  int ry = 1;
  while (ry < 8 && 2 * ry * qx <= kThreads) ry *= 2;
  const dim3 block(qx, ry);
  const size_t smem = sizeof(float4) * (size_t)qx * ry;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec4)
    stream_map<true><<<nblocks, block, smem, s>>>(val, row_stride, cols, tiles,
                                                  tiles_per_block, scratch);
  else
    stream_map<false><<<nblocks, block, smem, s>>>(val, row_stride, cols,
                                                   tiles, tiles_per_block,
                                                   scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stream_fold<<<1, kOutCols, 0, s>>>(scratch, nblocks, cols, out);
  return (int)cudaGetLastError();
}

extern "C" const char* streamprobe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
