// The segment fold on Hopper: the reference's segment_sum, in row order.
//
// Replaces no pallas_call. The reference's map phase
// (filodb_tpu/ops/aggregators.py::partial_aggregate) folds rows with the
// plain jax.ops.segment_sum (filodb_tpu/ops/aggregators.py:71) whenever
// stable=True or G > 64. That fold adds a group's rows in ROW ORDER, each
// output column on its own, so its answer depends neither on the padded
// step bucket nor on row padding, and a recording rule's derived sample
// equals its instant query bit for bit. The port's plain twin
// (ops/segfold.py::segment_fold_plain) is index_add_: a sequential loop in
// row order on the CPU, f64 atomics in an order that changes from run to
// run on the card. No PyTorch call gives a row-order f64 fold at speed
// (index_put_ with accumulate=True walks a group's rows one load at a
// time, and on the card keeps the row order in some shapes only), hence
// this kernel.
//
// What it computes, for every group g < G and column t < T, over g's rows
// r_0 < r_1 < ... (rows whose gid lies outside [0, G) belong to no group):
//   sum[g, t]   = ((+0.0 + z(r_0, t)) + z(r_1, t)) + ...   in f64
//   sumsq[g, t] = the same over (double)(z * z), z squared in V
//   count[g, t] = the number of those rows whose value at t is not NaN
// where z = isnan(v) ? 0 : v, widened to f64 exactly. A NaN row still adds
// +0.0 (-0.0 + 0.0 is +0.0), as the twin's index_add_ of the zeroed values
// does. Built with --fmad=false, so sumsq's add is never contracted with
// its square (V = double). Every add is the twin's add in the twin's
// order, so kernel, CPU twin and reference agree bit for bit.
//
// What bounds it. Bytes on paper: the values are read once (S * T * 4 or
// 8), the row list and offsets once, the [G, T] outputs written once.
// But each (g, t) is one chain of dependent f64 adds as long as g's row
// count, and no two of its adds can run together without changing the
// rounding. Where G * T is small and a group is long (sum(m) over 2^20
// series at one instant: one chain of ~2^20 adds), the chain's latency
// bounds it (about 4.5 ns an add on an H100, chip_smoke.py phase 2e);
// where G * T runs into the thousands the chains run side by side and the
// bytes bound it.
//
// What the design does about it. One block per (group, tile of TW
// columns). Warp 0 folds: lane c adds column t0 + c of the group's rows
// in order, from shared memory, and does nothing else. The values wait
// there already zeroed and widened to f64 (their squares too), and the
// next eight rows' loads are issued before the current eight's adds, so
// the chain waits on the adder alone. Warps 1-8 feed it. A ring of
// kStages stages of kChunk raw elements ([kChunk / TW rows, TW columns])
// holds the next chunks of the group's rows, copied with cp.async (a
// warp's lanes on consecutive columns of one row); each copy thread holds
// the row indices of the chunk after the one it issues in registers. A
// copy thread then zeroes, widens and counts the elements it copied
// itself (cp.async.wait_group makes its own copies visible to it, no
// barrier needed) into a double-buffered f64 stage for warp 0. One
// barrier a chunk. A copy thread's elements all lie in one column, so its
// count is one integer, gathered per column with shared atomics at the
// end: exact in any order. TW is the power of two at or above min(T, 32),
// halved while the blocks would not fill the SMs: one group over 47
// columns runs 47 chains on 47 SMs, not two blocks of 32 lanes. The block
// writes its outputs itself: no global atomics, no cross-block pass, the
// same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCopiers = 256;             // warps 1-8
constexpr int kThreads = 32 + kCopiers;   // warp 0 folds
constexpr int kChunk = 1024;              // elements a stage
constexpr int kStages = 4;
constexpr int kPer = kChunk / kCopiers;   // elements a copy thread a stage
constexpr int kUnroll = 8;                // rows loaded ahead of the adds

struct Params {
  const void* values;         // [S, T] V, contiguous
  const long long* order;     // row indices grouped by gid, ascending within
                              // a group
  const long long* offsets;   // [G + 1]: g's rows are order[offsets[g],
                              // offsets[g + 1])
  double* sum;                // [G, T]
  double* sumsq;              // [G, T], or null
  double* count;              // [G, T]
  long long T;
  int tiles;                  // column tiles a group: ceil(T / TW)
};

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename V, int TW, bool SumSq>
__global__ void __launch_bounds__(kThreads) segfold(Params p) {
  constexpr int R = kChunk / TW;   // rows a stage
  extern __shared__ __align__(16) unsigned char smem[];
  // zs (and qs): [2][kChunk] f64, the widened zeroed values (and squares)
  // of the chunk warp 0 folds and of the next; ring: [kStages][kChunk] V,
  // the raw rows in flight
  double* zs = reinterpret_cast<double*>(smem);
  double* qs = zs + 2 * kChunk;
  V* ring = reinterpret_cast<V*>(zs + (SumSq ? 4 : 2) * kChunk);
  int* counts = reinterpret_cast<int*>(ring + kStages * kChunk);   // [TW]
  const V* __restrict__ val = static_cast<const V*>(p.values);
  const int b = blockIdx.x;
  const int g = b / p.tiles;
  const long long t0 = (long long)(b - g * p.tiles) * TW;
  const long long begin = p.offsets[g];
  const long long rows = p.offsets[g + 1] - begin;
  const int chunks = (int)((rows + R - 1) / R);
  const int tid = threadIdx.x;
  const bool copier = tid >= 32;
  const int l = tid - 32;
  // a copy thread's elements l + u * kCopiers all lie in column l % TW
  // (kCopiers is a multiple of TW): row (l + u * kCopiers) / TW
  const bool col_ok = copier && t0 + l % TW < p.T;
  long long idx[kPer];
  auto fetch = [&](int k) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long r = (long long)k * R + (l + u * kCopiers) / TW;
      idx[u] = r < rows ? p.order[begin + r] : -1;
    }
  };
  auto issue = [&](int k) {
    V* stage = ring + (k % kStages) * kChunk;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = l + u * kCopiers;
      if (idx[u] >= 0 && col_ok)
        cp_async<(int)sizeof(V)>(stage + e, val + idx[u] * p.T + t0 + e % TW);
    }
    cp_async_commit();   // empty past the last chunk: the count stays even
  };
  // the thread's own elements of chunk k, landed: zeroed, widened (the
  // square taken in V first), counted
  int n = 0;
  auto convert = [&](int k) {
    const V* stage = ring + (k % kStages) * kChunk;
    double* z = zs + (k % 2) * kChunk;
    double* q = qs + (k % 2) * kChunk;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = l + u * kCopiers;
      if (col_ok && (long long)k * R + e / TW < rows) {
        const V v = stage[e];
        const bool present = !(v != v);
        z[e] = present ? (double)v : 0.0;
        if (SumSq) {
          const V vv = present ? v * v : V(0);
          q[e] = (double)vv;
        }
        n += present;
      }
    }
  };

  if (tid < TW) counts[tid] = 0;
  if (copier) {
    fetch(0);
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      issue(k);
      fetch(k + 1);
    }
    cp_async_wait<kStages - 1>();   // chunk 0 has landed
    convert(0);
  }
  __syncthreads();

  double s = 0.0, sq = 0.0;
  const bool folder = tid < TW && t0 + tid < p.T;
  for (int k = 0; k < chunks; ++k) {
    if (copier) {
      // chunk k's stage was converted before the last barrier: refill it
      issue(k + kStages);
      fetch(k + kStages + 1);
      cp_async_wait<kStages - 1>();   // chunk k + 1 has landed
      convert(k + 1);
    } else if (folder) {
      // chunk k's rows in order, the next kUnroll rows' loads issued
      // before the current ones' adds: the chain waits on the adder alone
      const double* zc = zs + (k % 2) * kChunk + tid;
      const double* qc = qs + (k % 2) * kChunk + tid;
      const int nr = (int)min((long long)R, rows - (long long)k * R);
      int r = 0;
      if (nr >= kUnroll) {
        double cz[kUnroll], cq[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          cz[u] = zc[u * TW];
          if (SumSq) cq[u] = qc[u * TW];
        }
        for (r = kUnroll; r + kUnroll <= nr; r += kUnroll) {
          double nz[kUnroll], nq[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            nz[u] = zc[(r + u) * TW];
            if (SumSq) nq[u] = qc[(r + u) * TW];
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            s = s + cz[u];
            if (SumSq) sq = sq + cq[u];
            cz[u] = nz[u];
            if (SumSq) cq[u] = nq[u];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s = s + cz[u];
          if (SumSq) sq = sq + cq[u];
        }
      }
      for (; r < nr; ++r) {
        s = s + zc[r * TW];
        if (SumSq) sq = sq + qc[r * TW];
      }
    }
    __syncthreads();
  }
  if (copier) {
    cp_async_wait<0>();
    if (col_ok) atomicAdd(&counts[l % TW], n);   // integers: any order
  }
  __syncthreads();
  if (folder) {
    const long long o = (long long)g * p.T + t0 + tid;
    p.sum[o] = s;
    if (SumSq) p.sumsq[o] = sq;
    p.count[o] = (double)counts[tid];
  }
}

template <typename V, int TW, bool SumSq>
cudaError_t launch(const Params& p, int blocks, cudaStream_t stream) {
  const int smem = (int)(sizeof(V) * kStages * kChunk +
                        sizeof(double) * (SumSq ? 4 : 2) * kChunk +
                        sizeof(int) * TW);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segfold<V, TW, SumSq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  segfold<V, TW, SumSq><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename V, bool SumSq>
cudaError_t launch_tw(int tw, const Params& p, int blocks,
                      cudaStream_t stream) {
  switch (tw) {
    case 1: return launch<V, 1, SumSq>(p, blocks, stream);
    case 2: return launch<V, 2, SumSq>(p, blocks, stream);
    case 4: return launch<V, 4, SumSq>(p, blocks, stream);
    case 8: return launch<V, 8, SumSq>(p, blocks, stream);
    case 16: return launch<V, 16, SumSq>(p, blocks, stream);
    default: return launch<V, 32, SumSq>(p, blocks, stream);
  }
}

}  // namespace

// values: [S, T] contiguous, f64 if is_f64 else f32; order: the in-range
// rows grouped by gid, ascending within a group; offsets: [G + 1] int64
// bounds of each group's rows in order; sum, count and (if sumsq is not
// null) sumsq: [G, T] f64, every element written. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, launching
// nothing, for a shape it does not take).
extern "C" int segfold_launch(const void* values, int is_f64, long long T,
                              const long long* order,
                              const long long* offsets, int G, double* sum,
                              double* sumsq, double* count, void* stream) {
  if (T < 1 || G < 1) return (int)cudaErrorInvalidValue;
  int tw = 1;
  while (tw < 32 && tw < T) tw *= 2;
  // fewer blocks than SMs: narrower tiles, so every column's chain gets
  // an SM of its own (the chains, not the bytes, bound a fold this small)
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  while (tw > 1 && ((T + tw - 1) / tw) * (long long)G < sms) tw /= 2;
  const long long tiles = (T + tw - 1) / tw;
  if (tiles * G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Params p{values, order, offsets, sum, sumsq, count, T, (int)tiles};
  const int blocks = (int)(tiles * G);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_f64)
    return (int)(sumsq ? launch_tw<double, true>(tw, p, blocks, s)
                       : launch_tw<double, false>(tw, p, blocks, s));
  return (int)(sumsq ? launch_tw<float, true>(tw, p, blocks, s)
                     : launch_tw<float, false>(tw, p, blocks, s));
}

extern "C" const char* segfold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
