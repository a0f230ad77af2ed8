// K2 on Hopper: the fused histogram-quantile map kernel of the port.
//
// Replaces filodb_tpu/ops/fusedresident.py::build_hist_pallas (its body
// _hist_kernel_body, tile math hist_tile_contrib and fold _hist_fold): the
// map phase of histogram_quantile(q, sum by (...) (fn(h[w]))) for fn in
// {rate, increase, delta} over a 2D-delta-resident [S, C, B] block (i8 or
// i16 dd, ops/narrow.py build_narrow_hist). Per (row s, step t, bucket b):
// the window delta cumsum_b(dd @ band_open), the first-sample value
// F + cumsum_b(dd @ prefix_lo) with F = cumsum_b(first_d), Prometheus
// extrapolation with the per-bucket counter zero clamp, the cnt >= 2 mask;
// then the fold into per-group sum and count, [G, Tp * B] each (t * B + b).
//
// Why a different formulation is exact. dd is integer-valued, and every
// partial the encoder admits stays below 2^24: it verified that the stored
// dd rebuilds each cell exactly in f32, and the window sums are differences
// of those cells. Sums of such integers are exact in f32 in ANY order. So
// instead of multiplying by 0/1 band matrices, K2 builds each row's 2D
// prefix Q[c][b] = sum over c' <= c, b' <= b of dd (in 32-bit integers,
// only at the cells the query's steps need) and reads
//   window delta  = Q[min(hi, C-1)][b] - Q[lo][b]          (lo < c <= hi)
//   first sample  = F[b] + Q[min(max(lo,0), C-1)][b] - Q[0][b]   (0 < c)
// These two quantities equal the plain twin's bit for bit (chip_smoke.py
// checks it on the card with one row per group, where no fold rounds).
//
// Rounding. The extrapolation repeats hist_tile_contrib expression by
// expression in f32: dur_zero, the per-bucket clamp, extrap / sampled, and
// rate's constant 1000 / window_ms computed in double on the host and
// rounded to f32. Build with --fmad=false and without --use_fast_math, so
// no contraction or approximate division changes a rounding.
//
// Excluded rows. Rows whose group id lies outside [0, G) — the engine's
// cohort-pool rows carry gid 1 << 30 — add nothing. In the reference they
// go through the one-hot product as 0 * contribution; that is exactly 0
// because a contribution is always finite: dd is an integer, the time
// quantities are finite wherever cnt >= 2, a non-finite first-sample value
// only feeds comparisons (dur_zero), and masked cells select 0. So K2
// skips them, and rows with fewer than two samples (cnt < 2 everywhere).
//
// What bounds it. The dd block: each row's cells up to the last cell the
// query needs, read once (1.34 GB at S = 2^17, C = 320, B = 32, i8:
// 0.40 ms at the H100 SXM's 3.35 TB/s); first_d, n, gid and the tables
// are a few MB. Per (row, step, bucket) some 40 f32 operations: below the
// card's compute ridge, so bytes bound it (chip_smoke.py recomputes the
// bound for its run).
//
// What the design does about it. Blocks run over (row chunk x step tile).
// A block takes its rows a pass at a time: one thread per (row, bucket)
// walks the row's cells in order, adding dd (neighbouring threads read
// neighbouring buckets), and keeps the running column sum at each needed
// cell in shared memory; a second step turns those into bucket prefixes.
// Then one thread per output column (t, b) of the tile walks the pass's
// rows in order and adds into a shared [2, G, tile] accumulator that only
// it touches. A block writes its chunk's partials to scratch and
// fold_chunks (fold.cuh, shared with K1) sums the chunks in index order:
// a fixed fold order, no float atomics. This is the simple form: the walk
// keeps few bytes in flight per SM, and TMA staging is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kThreads = 256;

enum Fn {
  FN_RATE = 0,
  FN_INCREASE = 1,
  FN_DELTA = 2,
};

struct Params {
  const void* dd;        // [S, C, B] int8 or int16
  int rows;              // S
  int C;
  int B;
  const float* first_d;  // [S, B]
  const int* n;          // [S] valid sample count per row
  const int* gid;        // [S] group id per row; outside [0, G): excluded
  const int* lo;         // [Tp] window edge cells (lo, hi], hi = -1 on pads
  const int* hi;
  const int* rel;        // [Tp] step time relative to the grid base, ms
  const int* cells;      // [K] sorted needed cells, cells[0] == 0
  const int* slots;      // [3, Tp] slot in cells of min(hi, C-1), of
                         // min(lo, C-1) (-1: below cell 0) and of the
                         // first-sample cell (-1: empty prefix)
  int ncells;            // K
  int t0, t1;            // active steps [t0, t1): hi >= 0
  int tp;                // padded step count
  int groups;            // G
  int fn;                // Fn
  int window_ms;
  int interval_ms;
  float rate_scale;      // (float)(1000.0 / window_ms)
  int rows_per_block;
  int rows_pass;         // rows whose prefixes a block holds at a time
  int tile_steps;        // steps per block tile
  float* scratch;        // [nchunks, 2, G, Tp * B], zeroed
};

template <typename T>
__global__ void fused_hist_map(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int B = p.B;
  const int G = p.groups;
  const int K = p.ncells;
  const int CW = p.tile_steps * B;                       // tile columns
  float* acc = reinterpret_cast<float*>(smem_raw);       // [2, G, CW]
  float* Fs = acc + 2 * G * CW;                          // [rows_pass, B]
  unsigned* Qs = reinterpret_cast<unsigned*>(Fs + p.rows_pass * B);
  int* s_cells = reinterpret_cast<int*>(Qs + (size_t)p.rows_pass * K * B);
  int* s_n = s_cells + K;                                // [rows_pass]
  int* s_gid = s_n + p.rows_pass;                        // [rows_pass]

  const int tid = threadIdx.x;
  const int tile_t0 = p.t0 + blockIdx.y * p.tile_steps;
  const int tile_t1 = min(tile_t0 + p.tile_steps, p.t1);
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row_end = min(row0 + p.rows_per_block, p.rows);
  const bool counter = p.fn != FN_DELTA;
  const T* dd = static_cast<const T*>(p.dd);
  const size_t row_elems = (size_t)p.C * B;

  for (int i = tid; i < 2 * G * CW; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < K; i += kThreads) s_cells[i] = p.cells[i];
  const int cmax = p.cells[K - 1];

  for (int r0 = row0; r0 < row_end; r0 += p.rows_pass) {
    const int nr = min(p.rows_pass, row_end - r0);
    __syncthreads();   // the previous pass is consumed
    if (tid < nr) {
      const int nn = p.n[r0 + tid];
      const int g = p.gid[r0 + tid];
      s_n[tid] = nn;
      // a row adds nothing without a group or with fewer than 2 samples
      s_gid[tid] = (g >= 0 && g < G && nn >= 2) ? g : -1;
    }
    __syncthreads();

    // column sums over c at the needed cells: one thread per (row, bucket)
    if (tid < nr * B) {
      const int rl = tid / B;
      const int b = tid - rl * B;
      if (s_gid[rl] >= 0) {
        const T* src = dd + (size_t)(r0 + rl) * row_elems + b;
        unsigned* q = Qs + (size_t)rl * K * B + b;
        unsigned run = 0;       // wraps like the i32 sum it stands for
        int k = 0;
        int next = s_cells[0];
#pragma unroll 4
        for (int c = 0; c <= cmax; ++c) {
          run += (unsigned)(int)src[(size_t)c * B];
          if (c == next) {
            q[(size_t)k * B] = run;
            ++k;
            next = k < K ? s_cells[k] : -1;
          }
        }
      }
    }
    __syncthreads();
    // bucket prefixes of each snapshot, one thread per (row, cell); and
    // F = cumsum_b(first_d) in f32, in bucket order, one thread per row
    for (int i = tid; i < nr * K; i += kThreads) {
      if (s_gid[i / K] < 0) continue;
      unsigned* q = Qs + (size_t)i * B;
      unsigned run = 0;
      for (int b = 0; b < B; ++b) {
        run += q[b];
        q[b] = run;
      }
    }
    for (int rl = tid; rl < nr; rl += kThreads) {
      if (s_gid[rl] < 0) continue;
      const float* fd = p.first_d + (size_t)(r0 + rl) * B;
      float run = 0.f;
      for (int b = 0; b < B; ++b) {
        run = run + fd[b];
        Fs[rl * B + b] = run;
      }
    }
    __syncthreads();

    // one thread per output column (t, b) of the tile, rows in order
    for (int jl = tid; jl < CW; jl += kThreads) {
      const int t = tile_t0 + jl / B;
      if (t >= tile_t1) break;
      const int b = jl - (jl / B) * B;
      const int lo_t = p.lo[t];
      const int hi_t = p.hi[t];
      if (hi_t < 0) continue;           // cnt = 0 for every row
      const int sh = p.slots[t];
      const int sl = p.slots[p.tp + t];
      const int sf = p.slots[2 * p.tp + t];
      const bool band = hi_t > lo_t;    // (lo, hi] holds a cell
      const int f_idx = max(lo_t, 0);
      const float relf = (float)p.rel[t];
      const float f_rel = (float)(f_idx * p.interval_ms);
      const float dur_start = (f_rel - (relf - (float)p.window_ms)) / 1000.0f;
      for (int rl = 0; rl < nr; ++rl) {
        const int g = s_gid[rl];
        if (g < 0) continue;
        const int l_idx = min(hi_t, s_n[rl] - 1);
        const int cnt = max(l_idx - f_idx + 1, 0);
        if (cnt < 2) continue;          // contributes 0 to sum and count
        const unsigned* q = Qs + (size_t)rl * K * B + b;
        const int di = band ? (int)(q[(size_t)sh * B]
                                    - (sl >= 0 ? q[(size_t)sl * B] : 0u))
                            : 0;
        const int fi = sf >= 0 ? (int)(q[(size_t)sf * B] - q[0]) : 0;
        const float delta = (float)di;
        const float f_v = Fs[rl * B + b] + (float)fi;

        const float cnt_f = (float)cnt;
        const float l_rel = (float)(l_idx * p.interval_ms);
        const float dur_end = (relf - l_rel) / 1000.0f;
        const float sampled = (l_rel - f_rel) / 1000.0f;
        const float avg_dur = sampled / (cnt_f - 1.0f);
        const float thresh = avg_dur * 1.1f;
        float ds = dur_start;
        if (counter) {
          const float safe = delta > 0.f ? delta : 1.0f;
          const float dur_zero = delta > 0.f ? sampled * (f_v / safe)
                                             : INFINITY;
          if (delta > 0.f && f_v >= 0.f && dur_zero < ds) ds = dur_zero;
        }
        float extrap = sampled;
        extrap = extrap + (ds < thresh ? ds : avg_dur / 2.0f);
        extrap = extrap + (dur_end < thresh ? dur_end : avg_dur / 2.0f);
        float scaled = delta * (extrap / sampled);
        if (p.fn == FN_RATE) scaled = scaled * p.rate_scale;
        acc[g * CW + jl] += scaled;
        acc[(G + g) * CW + jl] += 1.0f;
      }
    }
  }
  __syncthreads();
  // this block's tile of its chunk's partials
  float* out = p.scratch + (size_t)blockIdx.x * 2 * G * p.tp * B;
  const size_t tb = (size_t)p.tp * B;
  for (int i = tid; i < 2 * G * CW; i += kThreads) {
    const int o = i / CW;             // part * G + g
    const int jl = i - o * CW;
    if (tile_t0 + jl / B < tile_t1)
      out[(size_t)o * tb + (size_t)tile_t0 * B + jl] = acc[i];
  }
}

template <typename T>
cudaError_t launch_map(const Params& p, dim3 grid, size_t smem,
                       cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_hist_map<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_hist_map<T><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fusedhist_launch(
    const void* dd, int dd_bytes, int rows, int C, int B,
    const float* first_d, const int* n, const int* gid,
    const int* lo, const int* hi, const int* rel, const int* cells,
    const int* slots, int ncells, int t0, int t1,
    int tp, int groups, int fn, int window_ms, int interval_ms,
    float rate_scale, int rows_per_block, int rows_pass, int tile_steps,
    float* scratch, int nchunks, float* out, void* stream) {
  Params p;
  p.dd = dd;
  p.rows = rows;
  p.C = C;
  p.B = B;
  p.first_d = first_d;
  p.n = n;
  p.gid = gid;
  p.lo = lo;
  p.hi = hi;
  p.rel = rel;
  p.cells = cells;
  p.slots = slots;
  p.ncells = ncells;
  p.t0 = t0;
  p.t1 = t1;
  p.tp = tp;
  p.groups = groups;
  p.fn = fn;
  p.window_ms = window_ms;
  p.interval_ms = interval_ms;
  p.rate_scale = rate_scale;
  p.rows_per_block = rows_per_block;
  p.rows_pass = rows_pass;
  p.tile_steps = tile_steps;
  p.scratch = scratch;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t cw = (size_t)tile_steps * B;
  const size_t smem =
      sizeof(float) * (2 * (size_t)groups * cw + (size_t)rows_pass * B)
      + sizeof(unsigned) * (size_t)rows_pass * ncells * B
      + sizeof(int) * ((size_t)ncells + 2 * (size_t)rows_pass);
  const int ntiles = t1 > t0 ? (t1 - t0 + tile_steps - 1) / tile_steps : 0;
  if (ntiles > 0) {
    const dim3 grid(nchunks, ntiles);
    const cudaError_t err = dd_bytes == 1
        ? launch_map<int8_t>(p, grid, smem, s)
        : launch_map<int16_t>(p, grid, smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_fold(scratch, out, nchunks, 2 * groups * tp * B, s);
}

// the fold alone, on a K2 launch's scratch: lets a caller time the two
// passes apart
extern "C" int fusedhist_fold(const float* scratch, float* out, int nchunks,
                              int per_chunk, void* stream) {
  return (int)launch_fold(scratch, out, nchunks, per_chunk,
                          reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* fusedhist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
