// K1 on Hopper: the fused single-pass grid kernel of the port.
//
// Replaces filodb_tpu/ops/fusedgrid.py::build_pallas (its body _kernel_body
// and tile math tile_contrib): the partial state of op(fn(m[w])) over a
// grid-aligned [S, C] f32 value store, read once. For fn in {rate, increase,
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
// What bounds it. The value store: the kernel reads val[:, c0:c0+Ca] once.
// At bench.py's shape (S = 2^20 series, Ca = C = 768 columns for the full
// 2 h range) that is 3.22 GB, 0.96 ms at the H100 SXM data sheet's
// 3.35 TB/s; n, gid and the step operands are a few MB. The operations are
// a few per byte, far below the card's compute ridge, so bytes bound it
// (chip_smoke.py recomputes the bound for the card it runs on).
//
// What the design does about it. Blocks run over (row chunk x step chunk of
// 128 steps). A block stages RT rows of its chunk at a time in shared memory
// with coalesced (16-byte where aligned) loads, then each of its 128 threads
// owns one step column: it walks the staged rows in order and adds into a
// shared [nout, G, 128] accumulator that only it touches, so the per-block
// fold has a fixed order and no atomics. Steps with hi < 0 (the padding up
// to Tp) contribute nothing and skip the row walk. A block writes its
// chunk's partials to scratch; fused_grid_fold then sums the chunks in
// index order (the TPU grid accumulated tiles in order; blocks here run in
// parallel, so the cross-block sum is a second pass, never float atomics).
// Keeping several loads in flight per SM while other blocks compute is left
// to occupancy; a TMA ring of tiles is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

struct Params {
  const float* val;      // [S, row_stride], columns [c0, c0 + ca) are read
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
  int vec4;              // 16-byte loads are aligned
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
    if (p.vec4) {
      const int ca4 = p.ca >> 2;
      for (int i = tid; i < nr * ca4; i += kSteps) {
        const int r = i / ca4;
        const int c4 = i - r * ca4;
        const float4 x = *reinterpret_cast<const float4*>(
            p.val + (long long)(r0 + r) * p.row_stride + c0 + 4 * c4);
        *reinterpret_cast<float4*>(tile + r * p.ca + 4 * c4) = x;
      }
    } else {
      for (int i = tid; i < nr * p.ca; i += kSteps) {
        const int r = i / p.ca;
        const int c = i - r * p.ca;
        tile[i] = p.val[(long long)(r0 + r) * p.row_stride + c0 + c];
      }
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

// out[i] = sum over chunks k, in index order, of scratch[k, i]
__global__ void fused_grid_fold(const float* scratch, float* out, int nchunks,
                                int per_chunk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_chunk) return;
  float s = 0.f;
  for (int k = 0; k < nchunks; ++k) s = s + scratch[(size_t)k * per_chunk + i];
  out[i] = s;
}

}  // namespace

extern "C" int fusedgrid_launch(
    const float* val, long long row_stride, int c0, int ca, int cap, int rows,
    const int* n, const int* gid, const int* lo, const int* hi, const int* rel,
    int tp, int groups, int fn, int nout, int window_ms, int interval_ms,
    float rate_scale, int rows_per_block, int rt, int vec4, float* scratch,
    int nchunks, float* out, void* stream) {
  Params p;
  p.val = val;
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
  cudaError_t err = cudaFuncSetAttribute(
      fused_grid_map, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nchunks, tp / kSteps);
  fused_grid_map<<<grid, kSteps, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_chunk = nout * groups * tp;
  fused_grid_fold<<<(per_chunk + 255) / 256, 256, 0, s>>>(scratch, out,
                                                          nchunks, per_chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* fusedgrid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
