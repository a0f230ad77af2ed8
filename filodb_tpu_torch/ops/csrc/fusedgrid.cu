// K1 on Hopper: the fused single-pass grid kernel of the port.
//
// Replaces filodb_tpu/ops/fusedgrid.py::build_pallas (its body _kernel_body
// and tile math tile_contrib): the partial state of op(fn(m[w])) over a
// grid-aligned [S, C] value store, read once. For fn in {rate, increase,
// delta}: counter-corrected increments, the window delta over (lo_t, hi_t],
// the first sample at max(lo_t, 0), Prometheus extrapolation and the cnt >= 2
// mask; for fn in {sum, avg, count}_over_time: the closed-window sum and the
// cnt >= 1 mask. Then the fold into per-group sum / count (/ sumsq for
// stddev and stdvar), [G, Tp] each.
//
// What it computes. Exactly what the Pallas kernel's band and one-hot
// products compute, without the products: per (row s, step t) the band
// product is a sum over a contiguous column range, so the kernel walks that
// range. The products' IEEE behaviour is kept: a non-finite cell outside a
// step's band still turns that step into NaN (x * 0), and a non-finite
// contribution of one row turns every other group's sum into NaN (the
// one-hot fold). The extrapolation repeats tile_contrib expression by
// expression in f32, with the rate constant 1000 / window_ms computed in
// double on the host and rounded to f32. Build with --fmad=false and without
// --use_fast_math so no contraction or approximate division changes the
// rounding.
//
// The decode stage. The store's value block is in one of the decode
// variants of ops/decodereg.py, the Pallas body's var.pallas(...) at
// filodb_tpu/ops/fusedgrid.py:151; the kernel is templated on it and only
// the staging differs. Every variant stages f32 values into the same
// shared-memory tile, and everything after the staging reads only that
// tile:
//   raw      f32 [S, C]          copied as it is;
//   quant16  i16 [S, C]          vmin[r] + ((float)q + 32768) * scale[r],
//                                the reference's order, one rounding each;
//   delta16  i16 [S, C], delta8 i8 [S, C]   anchor[r] + inclusive prefix
//                                sum of the row's deltas: one warp per
//                                staged row, 4 cells a lane, 128-cell
//                                chunks carried from one to the next.
// The delta encoder admits only integer deltas whose every prefix is within
// 2^23 (filodb_tpu/ops/narrow.py:173-177), so every partial sum of any
// order is an exact integer in f32 and the one rounding is the final add
// to the anchor, as in the plain anchor + cumsum. The delta variants need
// the whole row from cell 0: c0 = 0 and ca = C, or the launch is refused.
// Cohort-pool rows arrive with n = 0 and any block or anchor (NaN, Inf,
// garbage): the row walk and the non-finite counts read only cells < n,
// so they add nothing.
//
// What bounds it. The value store: the kernel reads val[:, c0:c0+Ca] once.
// At bench.py's shape (S = 2^20 series, Ca = C = 768 columns for the full
// 2 h range) that is 3.22 GB in f32, 0.96 ms at the H100 SXM data sheet's
// 3.35 TB/s; 0.81 GB (0.24 ms) for delta8, 1.61 GB (0.48 ms) for quant16
// and delta16; n, gid, the row operands and the step operands are a few
// MB. The operations are a few per byte, far below the card's compute
// ridge, so bytes bound it (chip_smoke.py recomputes the bound for the
// card it runs on).
//
// What the design does about it. Blocks run over (row chunk x step chunk of
// 128 steps). A block stages RT rows of its chunk at a time in shared memory
// with coalesced (16-byte where aligned) loads, then each of its 128 threads
// owns one step column: it walks the staged rows in order and adds into a
// shared [nout, G, 128] accumulator that only it touches, so the per-block
// fold has a fixed order and no atomics. Steps with hi < 0 (the padding up
// to Tp) contribute nothing and skip the row walk. A block writes its
// chunk's partials to scratch; fold_chunks then sums the chunks in
// index order (the TPU grid accumulated tiles in order; blocks here run in
// parallel, so the cross-block sum is a second pass, never float atomics;
// fold.cuh, shared with K2).
// Keeping several loads in flight per SM while other blocks compute is left
// to occupancy; a TMA ring of tiles is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kSteps = 128;   // steps per block == threads per block

enum Fn {
  FN_RATE = 0,
  FN_INCREASE = 1,
  FN_DELTA = 2,
  FN_SUM_OVER_TIME = 3,
  FN_AVG_OVER_TIME = 4,
  FN_COUNT_OVER_TIME = 5,
};

// the decode variant of the value block (KIND_CODES in ops/fusedgrid.py)
enum Kind {
  KIND_RAW = 0,
  KIND_QUANT16 = 1,
  KIND_DELTA16 = 2,
  KIND_DELTA8 = 3,
};

struct Params {
  const void* val;       // [S, row_stride] block of the kind's element type,
                         // columns [c0, c0 + ca) are read
  const float* row0;     // [S] quant16: vmin; delta16/delta8: anchor
  const float* row1;     // [S] quant16: scale
  long long row_stride;  // elements between rows (the store capacity C)
  int c0;                // first active column
  int ca;                // active column count
  int cap;               // store capacity C (one-hot positions clip to C-1)
  int rows;              // S
  const int* n;          // [S] valid sample count per row
  const int* gid;        // [S] dense group id per row
  const int* lo;         // [Tp] window edge cells (lo, hi], hi = -1 on pads
  const int* hi;
  const int* rel;        // [Tp] step time relative to the grid base, ms
  int tp;                // padded step count, a multiple of kSteps
  int groups;            // G
  int fn;                // Fn
  int nout;              // 2 (sum, count) or 3 (+ sumsq)
  int window_ms;
  int interval_ms;
  float rate_scale;      // (float)(1000.0 / window_ms)
  int rows_per_block;
  int rt;                // rows staged per shared-memory tile
  int vec4;              // 4-element vector loads are aligned
  float* scratch;        // [nchunks, nout, G, Tp]
};

__device__ __forceinline__ float relu_keep_nan(float d) {
  // jnp.maximum(d, 0): NaN propagates, -inf becomes 0
  return d < 0.f ? 0.f : d;
}

__device__ __forceinline__ float inc_of(const float* v, int lc, bool counter) {
  float d = v[lc] - v[lc - 1];
  return counter ? relu_keep_nan(d) : d;
}

// Stage rows [r0, r0 + nr) of each variant as f32 into tile[nr, ca].

__device__ __forceinline__ void stage_raw(const Params& p, float* tile,
                                          int r0, int nr, int tid) {
  const float* val = static_cast<const float*>(p.val);
  const int c0 = p.c0;
  if (p.vec4) {
    const int ca4 = p.ca >> 2;
    for (int i = tid; i < nr * ca4; i += kSteps) {
      const int r = i / ca4;
      const int c4 = i - r * ca4;
      const float4 x = *reinterpret_cast<const float4*>(
          val + (long long)(r0 + r) * p.row_stride + c0 + 4 * c4);
      *reinterpret_cast<float4*>(tile + r * p.ca + 4 * c4) = x;
    }
  } else {
    for (int i = tid; i < nr * p.ca; i += kSteps) {
      const int r = i / p.ca;
      const int c = i - r * p.ca;
      tile[i] = val[(long long)(r0 + r) * p.row_stride + c0 + c];
    }
  }
}

__device__ __forceinline__ float dequant16(int16_t q, float vmin,
                                           float scale) {
  return vmin + ((float)q + 32768.f) * scale;
}

__device__ __forceinline__ void stage_quant16(const Params& p, float* tile,
                                              int r0, int nr, int tid) {
  const int16_t* q = static_cast<const int16_t*>(p.val);
  const int c0 = p.c0;
  if (p.vec4) {   // 4 cells, 8 bytes, a load
    const int ca4 = p.ca >> 2;
    for (int i = tid; i < nr * ca4; i += kSteps) {
      const int r = i / ca4;
      const int c4 = i - r * ca4;
      const short4 x = *reinterpret_cast<const short4*>(
          q + (long long)(r0 + r) * p.row_stride + c0 + 4 * c4);
      const float vmin = p.row0[r0 + r];
      const float scale = p.row1[r0 + r];
      float4 y;
      y.x = dequant16(x.x, vmin, scale);
      y.y = dequant16(x.y, vmin, scale);
      y.z = dequant16(x.z, vmin, scale);
      y.w = dequant16(x.w, vmin, scale);
      *reinterpret_cast<float4*>(tile + r * p.ca + 4 * c4) = y;
    }
  } else {
    for (int i = tid; i < nr * p.ca; i += kSteps) {
      const int r = i / p.ca;
      const int c = i - r * p.ca;
      tile[i] = dequant16(q[(long long)(r0 + r) * p.row_stride + c0 + c],
                          p.row0[r0 + r], p.row1[r0 + r]);
    }
  }
}

__device__ __forceinline__ void load4(const int8_t* s, float* x) {
  const char4 v = *reinterpret_cast<const char4*>(s);
  x[0] = (float)v.x; x[1] = (float)v.y; x[2] = (float)v.z; x[3] = (float)v.w;
}

__device__ __forceinline__ void load4(const int16_t* s, float* x) {
  const short4 v = *reinterpret_cast<const short4*>(s);
  x[0] = (float)v.x; x[1] = (float)v.y; x[2] = (float)v.z; x[3] = (float)v.w;
}

template <typename T>
__device__ __forceinline__ void stage_delta(const Params& p, float* tile,
                                            int r0, int nr, int warp,
                                            int lane) {
  const T* blk = static_cast<const T*>(p.val);
  const int ca = p.ca;             // == C: the launch checked c0 = 0
  for (int r = warp; r < nr; r += kSteps / 32) {
    const T* src = blk + (long long)(r0 + r) * p.row_stride;
    float* dst = tile + r * ca;
    const float anchor = p.row0[r0 + r];
    float carry = 0.f;             // sum of the row's cells before the chunk
    for (int base = 0; base < ca; base += 128) {
      const int c = base + 4 * lane;
      float x[4];
      if (p.vec4 && c + 3 < ca) {
        load4(src + c, x);
      } else {
        for (int k = 0; k < 4; ++k) x[k] = c + k < ca ? (float)src[c + k] : 0.f;
      }
      // inclusive prefix over the lane's 4 cells, then over the lanes
      x[1] = x[0] + x[1];
      x[2] = x[1] + x[2];
      x[3] = x[2] + x[3];
      float tot = x[3];
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot = tot + y;
      }
      float excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) excl = 0.f;
      const float before = carry + excl;   // sum of the cells before c
      for (int k = 0; k < 4; ++k)
        if (c + k < ca) dst[c + k] = anchor + (before + x[k]);
      carry = carry + __shfl_sync(0xffffffffu, tot, 31);
    }
  }
}

template <int K>
__global__ void fused_grid_map(Params p) {
  extern __shared__ float smem[];
  float* tile = smem;                                   // [rt, ca]
  float* acc = tile + p.rt * p.ca;                      // [nout, G, kSteps]
  int* s_n = reinterpret_cast<int*>(acc + p.nout * p.groups * kSteps);
  int* s_gid = s_n + p.rt;
  int* s_nfv = s_gid + p.rt;      // non-finite valid values per staged row
  int* s_nfi = s_nfv + p.rt;      // non-finite increments per staged row

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = blockIdx.y * kSteps + tid;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row_end = min(row0 + p.rows_per_block, p.rows);
  const int G = p.groups;
  const bool window_fn = p.fn >= FN_SUM_OVER_TIME;
  const bool counter = p.fn == FN_RATE || p.fn == FN_INCREASE;
  const bool sumsq = p.nout == 3;

  for (int i = tid; i < p.nout * G * kSteps; i += kSteps) acc[i] = 0.f;

  const int lo_t = p.lo[t];
  const int hi_t = p.hi[t];
  const int rel_t = p.rel[t];
  // hi < 0 gives cnt = 0 for every row: nothing to add
  const bool active = hi_t >= 0;
  const int c0 = p.c0;
  const int f_idx = max(lo_t, 0);
  const int p_first = min(f_idx, p.cap - 1);   // one-hot row of the first sample

  for (int r0 = row0; r0 < row_end; r0 += p.rt) {
    const int nr = min(p.rt, row_end - r0);
    __syncthreads();   // the previous tile is consumed
    if constexpr (K == KIND_RAW) {
      stage_raw(p, tile, r0, nr, tid);
    } else if constexpr (K == KIND_QUANT16) {
      stage_quant16(p, tile, r0, nr, tid);
    } else if constexpr (K == KIND_DELTA16) {
      stage_delta<int16_t>(p, tile, r0, nr, warp, lane);
    } else {
      stage_delta<int8_t>(p, tile, r0, nr, warp, lane);
    }
    for (int r = tid; r < nr; r += kSteps) {
      s_n[r] = p.n[r0 + r];
      s_gid[r] = p.gid[r0 + r];
    }
    __syncthreads();
    // per-row count of non-finite cells the band products multiply by 0:
    // values in [c0, vend) and increments in [c0 + 1, vend)
    for (int r = warp; r < nr; r += kSteps / 32) {
      const float* v = tile + r * p.ca;
      const int vend = min(c0 + p.ca, s_n[r]);
      int nfv = 0, nfi = 0;
      for (int c = c0 + lane; c < vend; c += 32) {
        nfv += !isfinite(v[c - c0]);
        if (!window_fn && c > c0) nfi += !isfinite(inc_of(v, c - c0, counter));
      }
      for (int off = 16; off > 0; off >>= 1) {
        nfv += __shfl_xor_sync(0xffffffffu, nfv, off);
        nfi += __shfl_xor_sync(0xffffffffu, nfi, off);
      }
      if (lane == 0) {
        s_nfv[r] = nfv;
        s_nfi[r] = nfi;
      }
    }
    __syncthreads();
    if (!active) continue;

    for (int r = 0; r < nr; ++r) {
      const float* v = tile + r * p.ca;
      const int n_s = s_n[r];
      const int vend = min(c0 + p.ca, n_s);    // valid active cells [c0, vend)
      const int l_idx = min(hi_t, n_s - 1);
      const int cnt = max(l_idx - f_idx + 1, 0);
      const float cnt_f = (float)cnt;
      float contrib, okf;
      if (window_fn) {
        const bool ok = cnt >= 1;
        if (p.fn == FN_COUNT_OVER_TIME) {
          contrib = ok ? cnt_f : 0.f;
        } else {
          // v @ band_closed: cells lo_t <= c <= hi_t
          const int cs = max(lo_t, c0);
          const int ce = min(hi_t, vend - 1);
          float s = 0.f;
          int nf_in = 0;
          for (int c = cs; c <= ce; ++c) {
            const float x = v[c - c0];
            s = s + x;
            nf_in += !isfinite(x);
          }
          if (s_nfv[r] > nf_in) s = NAN;
          if (p.fn == FN_AVG_OVER_TIME) s = s / cnt_f;
          contrib = ok ? s : 0.f;
        }
        okf = ok ? 1.f : 0.f;
      } else {
        // inc @ band_open: cells lo_t < c <= hi_t with a valid predecessor
        const int cs = max(lo_t + 1, c0 + 1);
        const int ce = min(hi_t, vend - 1);
        float delta = 0.f;
        int nf_in = 0;
        for (int c = cs; c <= ce; ++c) {
          const float d = inc_of(v, c - c0, counter);
          delta = delta + d;
          nf_in += !isfinite(d);
        }
        if (s_nfi[r] > nf_in) delta = NAN;
        // v @ onehot_lo: the first sample, 0 outside the valid active cells
        const bool in = p_first >= c0 && p_first < vend;
        const float x = in ? v[p_first - c0] : 0.f;
        const int nf_out = s_nfv[r] - ((in && !isfinite(x)) ? 1 : 0);
        const float f_v = nf_out > 0 ? NAN : x;

        const float relf = (float)rel_t;
        const float f_rel = (float)(f_idx * p.interval_ms);
        const float l_rel = (float)(l_idx * p.interval_ms);
        float dur_start = (f_rel - (relf - (float)p.window_ms)) / 1000.0f;
        const float dur_end = (relf - l_rel) / 1000.0f;
        const float sampled = (l_rel - f_rel) / 1000.0f;
        const float avg_dur = sampled / (cnt_f - 1.0f);
        if (counter) {
          const float safe = delta > 0.f ? delta : 1.0f;
          const float q = f_v / safe;
          const float dur_zero = delta > 0.f ? sampled * q : INFINITY;
          if (delta > 0.f && f_v >= 0.f && dur_zero < dur_start)
            dur_start = dur_zero;
        }
        const float thresh = avg_dur * 1.1f;
        float extrap = sampled;
        extrap = extrap + (dur_start < thresh ? dur_start : avg_dur / 2.0f);
        extrap = extrap + (dur_end < thresh ? dur_end : avg_dur / 2.0f);
        float scaled = delta * (extrap / sampled);
        if (p.fn == FN_RATE) scaled = scaled * p.rate_scale;
        const bool ok = cnt >= 2;
        contrib = ok ? scaled : 0.f;
        okf = ok ? 1.f : 0.f;
      }

      // one-hot fold: row -> its group; a non-finite term times 0 is NaN
      // in every other group's sum
      const int g = s_gid[r];
      const bool in_g = g >= 0 && g < G;
      float* a_sum = acc;
      float* a_cnt = acc + G * kSteps;
      if (in_g) {
        a_sum[g * kSteps + tid] += contrib;
        a_cnt[g * kSteps + tid] += okf;
      }
      if (!isfinite(contrib)) {
        for (int k = 0; k < G; ++k)
          if (k != g) a_sum[k * kSteps + tid] += NAN;
      }
      if (sumsq) {
        float* a_sq = acc + 2 * G * kSteps;
        const float sq = contrib * contrib;
        if (in_g) a_sq[g * kSteps + tid] += sq;
        if (!isfinite(sq)) {
          for (int k = 0; k < G; ++k)
            if (k != g) a_sq[k * kSteps + tid] += NAN;
        }
      }
    }
  }
  __syncthreads();
  float* out = p.scratch + (size_t)blockIdx.x * p.nout * G * p.tp;
  for (int o = 0; o < p.nout; ++o)
    for (int g = 0; g < G; ++g)
      out[(size_t)(o * G + g) * p.tp + t] = acc[(o * G + g) * kSteps + tid];
}

template <int K>
cudaError_t launch_map(const Params& p, dim3 grid, size_t smem,
                       cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_grid_map<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_grid_map<K><<<grid, kSteps, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fusedgrid_launch(
    const void* val, int kind, const float* row0, const float* row1,
    long long row_stride, int c0, int ca, int cap, int rows,
    const int* n, const int* gid, const int* lo, const int* hi, const int* rel,
    int tp, int groups, int fn, int nout, int window_ms, int interval_ms,
    float rate_scale, int rows_per_block, int rt, int vec4, float* scratch,
    int nchunks, float* out, void* stream) {
  // the delta variants decode from cell 0 of the whole row
  if ((kind == KIND_DELTA16 || kind == KIND_DELTA8) && (c0 != 0 || ca != cap))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.val = val;
  p.row0 = row0;
  p.row1 = row1;
  p.row_stride = row_stride;
  p.c0 = c0;
  p.ca = ca;
  p.cap = cap;
  p.rows = rows;
  p.n = n;
  p.gid = gid;
  p.lo = lo;
  p.hi = hi;
  p.rel = rel;
  p.tp = tp;
  p.groups = groups;
  p.fn = fn;
  p.nout = nout;
  p.window_ms = window_ms;
  p.interval_ms = interval_ms;
  p.rate_scale = rate_scale;
  p.rows_per_block = rows_per_block;
  p.rt = rt;
  p.vec4 = vec4;
  p.scratch = scratch;
  const size_t smem = sizeof(float) * ((size_t)rt * ca
                                       + (size_t)nout * groups * kSteps)
                      + sizeof(int) * 4 * (size_t)rt;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(nchunks, tp / kSteps);
  cudaError_t err;
  switch (kind) {
    case KIND_RAW: err = launch_map<KIND_RAW>(p, grid, smem, s); break;
    case KIND_QUANT16: err = launch_map<KIND_QUANT16>(p, grid, smem, s); break;
    case KIND_DELTA16: err = launch_map<KIND_DELTA16>(p, grid, smem, s); break;
    case KIND_DELTA8: err = launch_map<KIND_DELTA8>(p, grid, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold(scratch, out, nchunks, nout * groups * tp, s);
}

extern "C" const char* fusedgrid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
