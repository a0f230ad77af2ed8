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
// checks it on the card with one row per group, where no fold rounds). The
// prefix sums wrap like the i32 sums they stand for, so any order of the
// integer additions gives the same bits: the design below reorders them
// freely.
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
// skips them, and rows with fewer than two samples (cnt < 2 everywhere):
// their bytes are never copied.
//
// What bounds it. The dd block: each live row's cells up to the last cell
// the query needs, read once (1.153 GB at S = 2^17, C = 320, B = 32, i8,
// 39 steps: 0.344 ms at the H100 SXM's 3.35 TB/s); first_d, n, gid and the
// tables are a few MB. Per (row, step, bucket) some 40 f32 operations with
// two IEEE divisions: below the card's compute ridge, so bytes bound it
// (chip_smoke.py recomputes the bound for its run), but the divisions and
// the shared-memory traffic come close enough that the work has to overlap
// the loads.
//
// What the design does about it. One block per row chunk walks every
// distinct active step, so dd is read once per launch (the engine pads a
// query's steps by repeating the last one; a repeated step is computed
// once and the fold copies its columns, which hold the same additions in
// the same order). Its rows come a pass (rows_pass rows) at a time through
// a two-stage ring in shared memory: each live row's bytes up to the last
// needed cell, as 16-byte cp.async copies of the 16-byte-aligned span that
// covers the row (any row stride works; the copy reaches at most 15 bytes
// either side of the row, inside the 16-byte sectors that hold its first
// and last byte), and its first_d. The copies of pass k+2 are issued as
// soon as pass k's bytes are summed, so they are in flight while pass k's
// extrapolation runs; two blocks share an SM, so one block's barrier-bound
// phases overlap the other's work. Each pass then, between barriers:
//   segment sums — the cells [0, cmax] are cut into segments that end at
//     every needed cell and hold at most 8 cells (k2_segments in
//     ops/fusedresident.py); one item per (row, segment, bucket group) sums
//     its cells in u32, four i8 buckets a 4-byte word in 16-bit lanes (or
//     two i16) where the rows are 4-byte aligned and B * elt % 4 == 0, one
//     element otherwise;
//   prefixes — a scan over the segments per (row, bucket) and a scan over
//     the buckets per (row, needed cell) turn the sums into Q (rows of B + 1
//     words: no bank conflicts); F is the f32 bucket cumsum of first_d in
//     bucket order, one thread per row;
//   time terms — once per (row, step): l_idx, cnt, l_rel, dur_end, sampled,
//     avg_dur, thresh (and avg_dur / 2), the same expressions as before;
//   contributions and fold — one thread per output column (t, b) walks the
//     pass's rows in row order, two at a time: delta, f_v, the clamp,
//     extrap, the two divisions, and adds into its column's [2, G]
//     accumulator. The current group's sum and count stay in registers and
//     go to the accumulator when the group changes, so the additions are
//     the same, in the same order, as into the accumulator itself.
// The accumulator [2, G, U * B] lives in shared memory where the block
// still leaves room for a second one on its SM, else in the block's own
// slice of the scratch partials (touched by one block only: no atomics;
// L2-resident read-modify-write, and only when a row's group differs from
// the last). A block writes its chunk's partials to scratch and fold_steps
// sums the chunks in index order (fold.cuh's fixed order; no float
// atomics). Where the columns outnumber a block's threads x kCols, or the
// time terms overrun their budget, the block takes the steps a tile at a
// time over the same staged pass (never a second read of dd).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// (K2_THREADS and K2_COLS in ops/fusedresident.py)
constexpr int kThreads = 256;   // threads per block
constexpr int kCols = 8;        // columns a thread owns per step tile

enum Fn {
  FN_RATE = 0,
  FN_INCREASE = 1,
  FN_DELTA = 2,
};

struct Params {
  const void* dd;        // [S, C, B] int8 or int16
  long long row_bytes;   // C * B * elt
  int rows;              // S
  int B;
  int cmax;              // last cell any step needs: cells [0, cmax] are read
  const float* first_d;  // [S, B]
  const int* n;          // [S] valid sample count per row
  const int* gid;        // [S] group id per row; outside [0, G): excluded
  const int* lo;         // [Tp] window edge cells (lo, hi], hi = -1 on pads
  const int* hi;
  const int* rel;        // [Tp] step time relative to the grid base, ms
  const int* slots;      // [3, Tp] slot in cells of min(hi, C-1), of
                         // min(lo, C-1) (-1: below cell 0) and of the
                         // first-sample cell (-1: empty prefix)
  const int* kseg;       // [K] segment that ends at each needed cell
  const int* bounds;     // [J + 1] segment j: cells [bounds[j], bounds[j+1])
  const int* usteps;     // [U] the distinct active steps (hi >= 0), in order
  int ncells;            // K
  int nsegs;             // J
  int nsteps;            // U
  int tp;                // padded step count
  int groups;            // G
  int fn;                // Fn
  int window_ms;
  int interval_ms;
  float rate_scale;      // (float)(1000.0 / window_ms)
  int rows_per_block;
  int rows_pass;         // rows staged per pass
  int tile_steps;        // steps whose time terms a block holds at a time
  int acc_shared;        // the accumulator lives in shared memory
  float* scratch;        // [nchunks, 2, G, U * B]
};

__host__ __device__ inline size_t r16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Shared memory of one block, in this order (k2_smem_bytes in
// ops/fusedresident.py mirrors the sum; change both together): the
// accumulator [2, G, ncols] f32 (when shared; rounded up to 16 bytes); two
// stages of rows_pass slots (a row's covering span, then its first_d); the
// time terms [rows_pass, tile_steps] float4; the prefixes [rows_pass, J,
// B + 1] u32 (a row of B buckets padded by one word, so a thread per (row,
// cell) that walks the buckets meets no bank conflict; the pad of a row's
// cell 0 is its zero word); F [rows_pass, B] f32; the terms' ok flags
// [rows_pass, tile_steps] i32; the n / gid ring [3, 2, rows_pass] i32; kseg
// [K] and bounds [J + 1] i32.
struct Layout {
  size_t span;    // bytes of a slot's dd span
  size_t slot;    // bytes of a slot
  size_t stage, terms, prefix, fsum, ok, meta, kseg, bounds, total;
};

__host__ __device__ inline Layout layout(int B, int elt, int cmax, int G,
                                         int ncols, int K, int J, int rp,
                                         int ts, bool acc_shared) {
  Layout L;
  L.span = r16((size_t)(cmax + 1) * B * elt + 15);
  L.slot = L.span + r16((size_t)4 * B);
  L.stage = acc_shared ? r16((size_t)4 * 2 * G * ncols) : 0;
  L.terms = L.stage + 2 * (size_t)rp * L.slot;
  L.prefix = L.terms + (size_t)16 * rp * ts;
  L.fsum = L.prefix + (size_t)4 * rp * J * (B + 1);
  L.ok = L.fsum + (size_t)4 * rp * B;
  L.meta = L.ok + (size_t)4 * rp * ts;
  L.kseg = L.meta + (size_t)4 * 6 * rp;
  L.bounds = L.kseg + (size_t)4 * K;
  L.total = L.bounds + (size_t)4 * (J + 1);
  return L;
}

// cp.async: a copy from device to shared memory that the issuing thread
// does not wait for; commit closes a group of them, wait_group<N> waits
// until at most N of the thread's groups are still in flight
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// i / d by a multiply (exact for 0 <= i < 2^31): an integer division is
// some twenty instructions, and the work-item loops take one an item
struct Divisor {
  unsigned long long m;   // ceil(2^64 / d); unused for d = 1
  int d;
};

__device__ __forceinline__ Divisor divisor(int d) {
  return {d > 1 ? ~0ull / (unsigned long long)d + 1ull : 0ull, d};
}

__device__ __forceinline__ int quot(int i, Divisor v) {
  return v.d > 1 ? (int)__umul64hi((unsigned long long)i, v.m) : i;
}

// byte address of row r's first element
__device__ __forceinline__ uintptr_t row_addr(const Params& p, int r) {
  return reinterpret_cast<uintptr_t>(p.dd) + (uintptr_t)r * p.row_bytes;
}

// issues the copies of a pass's live rows (gid >= 0 in its ring slot) into
// a stage, without waiting for them
template <typename T>
__device__ __forceinline__ void stage_pass(const Params& p, const Layout& L,
                                           unsigned char* st, const int* mg,
                                           int r0, int nr, int tid,
                                           Divisor by_row, Divisor by_b) {
  const size_t nbytes = (size_t)(p.cmax + 1) * p.B * sizeof(T);
  const int per_row = by_row.d;
  for (int i = tid; i < nr * per_row; i += kThreads) {
    const int rl = quot(i, by_row);
    const int c = i - rl * per_row;
    if (mg[rl] < 0) continue;
    const uintptr_t a = row_addr(p, r0 + rl);
    const uintptr_t lo = a & ~(uintptr_t)15;
    const uintptr_t hi = (a + nbytes + 15) & ~(uintptr_t)15;
    if (lo + 16 * (uintptr_t)c < hi)
      cp_async16(st + rl * L.slot + 16 * c,
                 reinterpret_cast<const void*>(lo + 16 * (uintptr_t)c));
  }
  for (int i = tid; i < nr * p.B; i += kThreads) {
    const int rl = quot(i, by_b);
    if (mg[rl] < 0) continue;
    cp_async4(st + rl * L.slot + L.span + 4 * (i - rl * p.B),
              p.first_d + (size_t)(r0 + rl) * p.B + (i - rl * p.B));
  }
}

// n and gid of a pass into a ring slot ([n: rp][gid: rp]); gid -1 marks a
// row that adds nothing (no group, or fewer than 2 samples, or past the end)
__device__ __forceinline__ void put_meta(int* slot, int rp, int rl, int nn,
                                         int g, int G) {
  slot[rl] = nn;
  slot[rp + rl] = (g >= 0 && g < G && nn >= 2) ? g : -1;
}

// adds the V elements of one bucket group at src into s
template <typename T, int V>
__device__ __forceinline__ void add_cell(unsigned (&s)[V],
                                         const unsigned char* src) {
  if constexpr (V == 1) {
    s[0] += (unsigned)(int)*reinterpret_cast<const T*>(src);
  } else {
    const int w = *reinterpret_cast<const int*>(src);
    constexpr int bits = 8 * (int)sizeof(T);
#pragma unroll
    for (int u = 0; u < V; ++u)
      s[u] += (unsigned)((w << (32 - bits * (u + 1))) >> (32 - bits));
  }
}

// One (row, step, bucket) item: the window delta Q[hi] - Q[lo] and the
// first-sample value F + Q[f] - Q[0] from the row's prefixes q (offsets of
// the column's cells; an empty band or prefix reads two equal words or the
// zero word), then hist_tile_contrib's extrapolation, in its order, one
// rounding at a time. tm = (sampled, thresh, dur_end, avg_dur / 2) of the
// (row, step). Garbage in for a row that adds nothing is harmless: the
// caller drops the result.
__device__ __forceinline__ float contribution(
    const unsigned* q, int oh, int ol, int of, int b, float F, float4 tm,
    float dur_start, bool counter, bool rate, float rate_scale) {
  const int di = (int)(q[oh] - q[ol]);
  const int fi = (int)(q[of] - q[b]);
  const float delta = (float)di;
  const float f_v = F + (float)fi;
  const float sampled = tm.x;
  const float thresh = tm.y;
  const float dur_end = tm.z;
  const float half = tm.w;
  float ds = dur_start;
  if (counter) {
    const float safe = delta > 0.f ? delta : 1.0f;
    const float dur_zero = delta > 0.f ? sampled * (f_v / safe) : INFINITY;
    if (delta > 0.f && f_v >= 0.f && dur_zero < ds) ds = dur_zero;
  }
  float extrap = sampled;
  extrap = extrap + (ds < thresh ? ds : half);
  extrap = extrap + (dur_end < thresh ? dur_end : half);
  float scaled = delta * (extrap / sampled);
  if (rate) scaled = scaled * rate_scale;
  return scaled;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2) fused_hist_map(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B;
  const int G = p.groups;
  const int K = p.ncells;
  const int J = p.nsegs;
  const int rp = p.rows_pass;
  const int ts = p.tile_steps;
  const int nsteps = p.nsteps;
  const int ncols = nsteps * B;
  const Layout L = layout(B, sizeof(T), p.cmax, G, ncols, K, J, rp, ts,
                          p.acc_shared != 0);
  unsigned char* stage = smem + L.stage;                       // [2, rp, slot]
  float4* terms = reinterpret_cast<float4*>(smem + L.terms);  // [rp, ts]
  unsigned* P = reinterpret_cast<unsigned*>(smem + L.prefix); // [rp, J, PB]
  const int PB = B + 1;                                       // P's row stride
  float* Fs = reinterpret_cast<float*>(smem + L.fsum);        // [rp, B]
  int* okt = reinterpret_cast<int*>(smem + L.ok);             // [rp, ts]
  int* meta = reinterpret_cast<int*>(smem + L.meta);          // [3, 2, rp]
  int* s_kseg = reinterpret_cast<int*>(smem + L.kseg);
  int* s_bounds = reinterpret_cast<int*>(smem + L.bounds);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row_end = min(row0 + p.rows_per_block, p.rows);
  const int npass = (row_end - row0 + rp - 1) / rp;
  const bool counter = p.fn != FN_DELTA;
  float* slice = p.scratch + (size_t)blockIdx.x * 2 * G * ncols;
  float* acc = p.acc_shared ? reinterpret_cast<float*>(smem) : slice;
  const int ng = B / V;                  // bucket groups a cell
  const Divisor by_b = divisor(B), by_k = divisor(K), by_g = divisor(ng),
                by_jg = divisor(J * ng), by_row = divisor((int)(L.span / 16));

  for (int i = tid; i < 2 * G * ncols; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < K; i += kThreads) s_kseg[i] = p.kseg[i];
  for (int i = tid; i <= J; i += kThreads) s_bounds[i] = p.bounds[i];
  // each row's pad word after Q[0][B - 1] is the zero word: no phase
  // writes it
  for (int i = tid; i < rp; i += kThreads) P[i * J * PB + B] = 0u;
  for (int i = tid; i < 2 * rp; i += kThreads) {    // passes 0 and 1
    const int r = row0 + i;
    const bool in = r < row_end;
    put_meta(meta + (i / rp) * 2 * rp, rp, i % rp, in ? p.n[r] : 0,
             in ? p.gid[r] : -1, G);
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    const int r0 = row0 + k * rp;
    stage_pass<T>(p, L, stage + k * rp * L.slot, meta + k * 2 * rp + rp, r0,
                  max(0, min(rp, row_end - r0)), tid, by_row, by_b);
    cp_async_commit();
  }

  const int ntiles = nsteps > 0 ? (nsteps + ts - 1) / ts : 0;
  const Divisor by_ts = divisor(ts);
  // each owned column's current group, sum and count (see the note)
  int cg[kCols];
  float cs[kCols], cc[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    cg[u] = -1;
    cs[u] = 0.f;
    cc[u] = 0.f;
  }

  for (int k = 0; k < npass; ++k) {
    const int r0 = row0 + k * rp;
    const int nr = min(rp, row_end - r0);
    // n and gid of pass k + 2, loaded now and used after the segment sums
    const int r2 = r0 + 2 * rp + tid;
    const bool in2 = tid < rp && r2 < row_end;
    const int pn = in2 ? p.n[r2] : 0;
    const int pg = in2 ? p.gid[r2] : -1;
    cp_async_wait<1>();
    __syncthreads();   // pass k has landed; pass k - 1 is consumed
    const int* mn = meta + (k % 3) * 2 * rp;
    const int* mg = mn + rp;
    unsigned char* st = stage + (k & 1) * rp * L.slot;

    // segment sums: one item per (row, segment, bucket group)
    for (int i = tid; i < nr * J * ng; i += kThreads) {
      const int rl = quot(i, by_jg);
      const int rem = i - rl * J * ng;
      const int j = quot(rem, by_g);
      const int bg = rem - j * ng;
      if (mg[rl] < 0) continue;
      const unsigned char* src = st + rl * L.slot
          + (row_addr(p, r0 + rl) & 15) + (size_t)bg * V * sizeof(T);
      const int cell = B * (int)sizeof(T);
      const int c0 = s_bounds[j];
      const int c1 = s_bounds[j + 1];
      unsigned* q = P + (rl * J + j) * PB + bg * V;
      if constexpr (sizeof(T) == 1 && V == 4) {
        // four i8 buckets a word, moved by 128 into [0, 255] and added in
        // two words of 16-bit lanes (a segment's at most 8 cells cannot
        // carry out of a lane), then moved back by 128 a cell: the same
        // sums mod 2^32 as adding the buckets one by one
        unsigned even = 0u, odd = 0u;
#pragma unroll 4
        for (int c = c0; c < c1; ++c) {
          const unsigned x =
              *reinterpret_cast<const unsigned*>(src + c * cell) ^ 0x80808080u;
          even += x & 0x00ff00ffu;
          odd += (x >> 8) & 0x00ff00ffu;
        }
        const unsigned bias = 128u * (unsigned)(c1 - c0);
        q[0] = (even & 0xffffu) - bias;
        q[1] = (odd & 0xffffu) - bias;
        q[2] = (even >> 16) - bias;
        q[3] = (odd >> 16) - bias;
      } else {
        unsigned s[V];
#pragma unroll
        for (int u = 0; u < V; ++u) s[u] = 0u;
#pragma unroll 4
        for (int c = c0; c < c1; ++c) add_cell<T, V>(s, src + c * cell);
#pragma unroll
        for (int u = 0; u < V; ++u) q[u] = s[u];
      }
    }
    // F = cumsum_b(first_d) in f32, in bucket order, one thread per row
    for (int rl = tid; rl < nr; rl += kThreads) {
      if (mg[rl] < 0) continue;
      const float* fd = reinterpret_cast<const float*>(st + rl * L.slot
                                                       + L.span);
      float run = 0.f;
      for (int b = 0; b < B; ++b) {
        run = run + fd[b];
        Fs[rl * B + b] = run;
      }
    }
    if (tid < rp)
      put_meta(meta + ((k + 2) % 3) * 2 * rp, rp, tid, pn, pg, G);
    __syncthreads();   // the stage is free; pass k + 2's rows are known
    {
      const int r0n = r0 + 2 * rp;
      stage_pass<T>(p, L, st, meta + ((k + 2) % 3) * 2 * rp + rp, r0n,
                    max(0, min(rp, row_end - r0n)), tid, by_row, by_b);
      cp_async_commit();
    }

    // column sums at each segment end: a scan over segments per (row, b)
    for (int i = tid; i < nr * B; i += kThreads) {
      const int rl = quot(i, by_b);
      if (mg[rl] < 0) continue;
      unsigned* q = P + rl * J * PB + (i - rl * B);
      unsigned run = 0u;     // wraps like the i32 sum it stands for
      for (int j0 = 0; j0 < J; j0 += 8) {
        unsigned v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = j0 + u < J ? q[(j0 + u) * PB] : 0u;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          run += v[u];
          if (j0 + u < J) q[(j0 + u) * PB] = run;
        }
      }
    }
    __syncthreads();
    // bucket prefixes at the needed cells: a thread per (row, cell)
    for (int i = tid; i < nr * K; i += kThreads) {
      const int rl = quot(i, by_k);
      if (mg[rl] < 0) continue;
      unsigned* q = P + (rl * J + s_kseg[i - rl * K]) * PB;
      unsigned run = 0u;
      for (int b0 = 0; b0 < B; b0 += 8) {
        unsigned v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = b0 + u < B ? q[b0 + u] : 0u;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          run += v[u];
          if (b0 + u < B) q[b0 + u] = run;
        }
      }
    }

    for (int tile = 0; tile < ntiles; ++tile) {
      const int ts0 = tile * ts;                 // first distinct step
      const int tsn = min(ts, nsteps - ts0);
      if (tile > 0) __syncthreads();   // the last tile's terms are consumed
      const Divisor by_tsn = tsn == ts ? by_ts : divisor(tsn);
      // time terms, once per (row, step)
      for (int i = tid; i < nr * tsn; i += kThreads) {
        const int rl = quot(i, by_tsn);
        const int tl = i - rl * tsn;
        const int t = p.usteps[ts0 + tl];
        const int hi_t = p.hi[t];
        int ok = 0;
        if (mg[rl] >= 0 && hi_t >= 0) {
          const int f_idx = max(p.lo[t], 0);
          const int l_idx = min(hi_t, mn[rl] - 1);
          const int cnt = max(l_idx - f_idx + 1, 0);
          if (cnt >= 2) {
            ok = 1;
            const float relf = (float)p.rel[t];
            const float f_rel = (float)(f_idx * p.interval_ms);
            const float cnt_f = (float)cnt;
            const float l_rel = (float)(l_idx * p.interval_ms);
            const float dur_end = (relf - l_rel) / 1000.0f;
            const float sampled = (l_rel - f_rel) / 1000.0f;
            const float avg_dur = sampled / (cnt_f - 1.0f);
            const float thresh = avg_dur * 1.1f;
            terms[rl * ts + tl] = make_float4(sampled, thresh, dur_end,
                                              avg_dur / 2.0f);
          }
        }
        okt[rl * ts + tl] = ok;
      }
      __syncthreads();

      // one thread per output column (t, b) of the tile, rows in order
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int jl = tid + u * kThreads;
        if (jl < tsn * B) {
          const int tl = quot(jl, by_b);
          const int b = jl - tl * B;
          const int t = p.usteps[ts0 + tl];
          const int ja = ts0 * B + jl;             // accumulator column
          const int lo_t = p.lo[t];
          const int hi_t = p.hi[t];
          const int sh = p.slots[t];
          const int sl = p.slots[p.tp + t];
          const int sf = p.slots[2 * p.tp + t];
          const bool band = hi_t > lo_t;    // (lo, hi] holds a cell
          // offsets in a row's prefixes [J, B + 1] of this column's cells:
          // Q[hi] and Q[lo] (the zero word where lo < 0; both the zero word
          // for an empty band: delta 0), Q[f] (Q[0] for an empty prefix)
          const int oh = band ? s_kseg[sh] * PB + b : B;
          const int ol = band && sl >= 0 ? s_kseg[sl] * PB + b : B;
          const int of = sf >= 0 ? s_kseg[sf] * PB + b : b;
          const int f_idx = max(lo_t, 0);
          const float relf = (float)p.rel[t];
          const float f_rel = (float)(f_idx * p.interval_ms);
          const float dur_start =
              (f_rel - (relf - (float)p.window_ms)) / 1000.0f;
          // the column's current group, sum and count, carried across the
          // passes (one tile) in cg / cs / cc
          int g0 = cg[u];
          float s0 = cs[u], n0 = cc[u];
          // two rows at a time (two independent chains of divisions in
          // flight), added in row order
          for (int r2 = 0; r2 < nr; r2 += 2) {
            float sc[2];
            bool ok[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rl = min(r2 + h, nr - 1);
              ok[h] = r2 + h < nr && okt[rl * ts + tl] != 0;
              sc[h] = contribution(P + rl * J * PB, oh, ol, of, b,
                                   Fs[rl * B + b], terms[rl * ts + tl],
                                   dur_start, counter, p.fn == FN_RATE,
                                   p.rate_scale);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!ok[h]) continue;             // adds 0 to sum and count
              const int g = mg[r2 + h];
              if (g != g0) {
                if (g0 >= 0) {
                  acc[(size_t)g0 * ncols + ja] = s0;
                  acc[(size_t)(G + g0) * ncols + ja] = n0;
                }
                g0 = g;
                s0 = acc[(size_t)g * ncols + ja];
                n0 = acc[(size_t)(G + g) * ncols + ja];
              }
              s0 += sc[h];
              n0 += 1.0f;
            }
          }
          if (ntiles > 1 && g0 >= 0) {   // the next tile owns other columns
            acc[(size_t)g0 * ncols + ja] = s0;
            acc[(size_t)(G + g0) * ncols + ja] = n0;
            g0 = -1;
          }
          cg[u] = g0;
          cs[u] = s0;
          cc[u] = n0;
        }
      }
    }
  }
  cp_async_wait<0>();
  // one tile: each thread kept its columns across the passes
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int ja = tid + u * kThreads;
    if (cg[u] >= 0 && ja < ncols) {
      acc[(size_t)cg[u] * ncols + ja] = cs[u];
      acc[(size_t)(G + cg[u]) * ncols + ja] = cc[u];
    }
  }
  if (p.acc_shared) {
    __syncthreads();
    for (int i = tid; i < 2 * G * ncols; i += kThreads) slice[i] = acc[i];
  }
}

// The second pass: out[o, t * B + b] = the sum over chunks k, in index
// order, of scratch[k, o, ucol[t] * B + b] (fold.cuh's fold_chunks over
// the distinct steps' columns; a repeated step reads its first copy's
// column, which holds the same additions in the same order), 0 where
// ucol[t] < 0 (no active step: what folding zeros gives)
__global__ void fold_steps(const float* scratch, float* out, int nchunks,
                           int rows, int B, int tp, int nsteps,
                           const int* ucol) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * tp * B) return;
  const int o = i / (tp * B);
  const int c = i - o * tp * B;
  const int t = c / B;
  const int u = ucol[t];
  float s = 0.f;
  if (u >= 0) {
    const size_t per_chunk = (size_t)rows * nsteps * B;
    const float* src = scratch + ((size_t)o * nsteps + u) * B + (c - t * B);
    for (int k = 0; k < nchunks; ++k) s = s + src[(size_t)k * per_chunk];
  }
  out[i] = s;
}

cudaError_t launch_fold(const float* scratch, float* out, int nchunks,
                        int rows, int B, int tp, int nsteps, const int* ucol,
                        cudaStream_t s) {
  const int total = rows * tp * B;
  fold_steps<<<(total + 255) / 256, 256, 0, s>>>(scratch, out, nchunks, rows,
                                                 B, tp, nsteps, ucol);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_map(const Params& p, int nchunks, size_t smem,
                       cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_hist_map<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_hist_map<T, V><<<nchunks, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fusedhist_launch(
    const void* dd, int dd_bytes, int rows, int C, int B,
    const float* first_d, const int* n, const int* gid,
    const int* lo, const int* hi, const int* rel, const int* slots,
    const int* kseg, const int* bounds, const int* usteps, const int* ucol,
    int ncells, int nsegs, int cmax, int nsteps, int tp, int groups, int fn,
    int window_ms,
    int interval_ms, float rate_scale, int rows_per_block, int rows_pass,
    int tile_steps, int acc_shared, float* scratch, int nchunks, float* out,
    void* stream) {
  Params p;
  p.dd = dd;
  p.row_bytes = (long long)C * B * dd_bytes;
  p.rows = rows;
  p.B = B;
  p.cmax = cmax;
  p.first_d = first_d;
  p.n = n;
  p.gid = gid;
  p.lo = lo;
  p.hi = hi;
  p.rel = rel;
  p.slots = slots;
  p.kseg = kseg;
  p.bounds = bounds;
  p.usteps = usteps;
  p.ncells = ncells;
  p.nsegs = nsegs;
  p.nsteps = nsteps;
  p.tp = tp;
  p.groups = groups;
  p.fn = fn;
  p.window_ms = window_ms;
  p.interval_ms = interval_ms;
  p.rate_scale = rate_scale;
  p.rows_per_block = rows_per_block;
  p.rows_pass = rows_pass;
  p.tile_steps = tile_steps;
  p.acc_shared = acc_shared;
  p.scratch = scratch;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int ncols = nsteps * B;
  if (ncols > 0) {
    if (B > 32 || tile_steps < 1 || tile_steps * B > kThreads * kCols
        || rows_pass < 1
        || bounds == nullptr || cmax < 0)
      return (int)cudaErrorInvalidValue;
    const size_t smem = layout(B, dd_bytes, cmax, groups, ncols, ncells,
                               nsegs, rows_pass, tile_steps,
                               acc_shared != 0).total;
    // 4-byte words hold whole bucket groups when every row starts 4-byte
    // aligned and a cell is a multiple of 4 bytes
    const bool vec = reinterpret_cast<uintptr_t>(dd) % 4 == 0
        && (B * dd_bytes) % 4 == 0;
    cudaError_t err;
    if (dd_bytes == 1)
      err = vec ? launch_map<int8_t, 4>(p, nchunks, smem, s)
                : launch_map<int8_t, 1>(p, nchunks, smem, s);
    else
      err = vec ? launch_map<int16_t, 2>(p, nchunks, smem, s)
                : launch_map<int16_t, 1>(p, nchunks, smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_fold(scratch, out, nchunks, 2 * groups, B, tp,
                          nsteps, ucol, s);
}

// the fold alone, on a K2 launch's scratch: lets a caller time the two
// passes apart
extern "C" int fusedhist_fold(const float* scratch, float* out, int nchunks,
                              int rows, int B, int tp, int nsteps,
                              const int* ucol, void* stream) {
  return (int)launch_fold(scratch, out, nchunks, rows, B, tp, nsteps, ucol,
                          reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* fusedhist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
