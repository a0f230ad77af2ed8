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
//                                sum of the row's deltas.
// The delta variants need the whole row from cell 0: c0 = 0 and ca = C, or
// the launch is refused. Cohort-pool rows arrive with n = 0 and any block
// or anchor (NaN, Inf, garbage): they are decoded like any other row, and
// the row walk and the non-finite counts read only cells < n, so they add
// nothing.
//
// The staging of the narrow variants. A two-stage ring [2, rt, Ca] of the
// block's own i16 or i8 holds tile k + 1's rows, copied with cp.async
// while tile k is decoded and worked, beside their n and gid; the row
// operands (quant16's vmin and scale, the delta variants' first-pass
// anchors) go into registers a tile ahead. The copies are 16 bytes where
// the first active byte, the row stride and the row length in bytes all
// allow it, else 8 or 4 (C = 1004, a view that starts at row 1); where not
// even 4 bytes divide them (an odd-length row) the cells take plain
// loads. quant16 keeps active-column slicing (c0 > 0, Ca < C): its
// threads copy the tile in flat chunks of one copy each, consecutive
// threads on consecutive chunks, and each thread dequantises the chunks it
// copied, vmin + ((float)q + 32768) * scale a cell, into the f32 tile with
// 16-byte stores that a quarter warp spreads over the eight bank groups;
// nothing but cp.async.wait_group stands between the copy and the
// dequantise. The delta decode is one pass of the whole block: each
// thread takes a run of 16 cells of one row (one 16-byte word of i8, two
// of i16), sums it in int32, and a segmented scan over the block (rows are
// the segments; warp shuffles, then the warps' totals through a few shared
// words) gives the run the sum of its row's cells before it; each cell is
// then anchor + (float)prefix, its int32 prefix one dot-product
// instruction from the run's. Each thread copies the cells it decodes, so only the scan needs a
// barrier. Exact: the encoder admits only integer deltas whose every
// prefix is within 2^23 (filodb_tpu/ops/narrow.py:173-177), so every int32
// partial sum and its conversion are exact, and the one rounding is the
// final add to the anchor, as in the plain anchor + cumsum and in the
// chunked f32 scan this replaced: the staged tile is bit for bit the same.
// The ring takes no more shared memory than raw's second f32 buffer (the
// i16 rings exactly as much); the ring kernels are held to 64 registers,
// so four blocks an SM still fit wherever they fit for raw.
//
// What bounds it. The bytes: the kernel reads val[:, c0:c0+Ca] once. At
// bench.py's shape (S = 2^20 series, Ca = C = 768 columns for the full 2 h
// range) that is 3.22 GB in f32, 0.96 ms at the H100 SXM data sheet's
// 3.35 TB/s; 0.81 GB (0.24 ms) for delta8, 1.61 GB (0.48 ms) for quant16
// and delta16; n, gid, the row operands and the step operands are a few
// MB. The operations (about 1.5e9 window cells and 49e6 extrapolations at
// 47 steps) are a few per byte, below the card's f32 ridge, so bytes bound
// it on paper (chip_smoke.py recomputes the bound for the card it runs
// on). In practice the per-tile phases below issue more slowly than the
// bytes arrive: raw runs at about twice its bound, and the narrow
// variants, whose tile phases are the same code over a quarter or a half
// of the bytes, near raw on their decoded block (PERF.md): the shared tile
// phases bound every variant.
//
// What the design does about it. Blocks of 256 threads run over (row chunk
// x step chunk of 128 steps). A block stages RT rows of its chunk at a time
// in shared memory (k1_launch_shape: about 4096 cells, four blocks an SM),
// then works each tile in three phases between barriers:
//   non-finite counts — a warp per row; a row whose cells all lie in
//     (-2^126, 2^126) is 0 and 0 after one compare a cell, only others are
//     counted cell by cell;
//   contributions — every thread of the block takes (row, step) items of
//     the tile: the staged rows x the chunk's live steps (hi >= 0, listed
//     once per block), consecutive threads on consecutive steps of one row
//     (neighbouring windows start a step's worth of cells apart, so a warp's
//     shared loads spread over the banks). Each item walks its window's
//     cells in ascending order and runs the extrapolation, and writes its
//     contribution and presence to shared [RT, 128] arrays. The time terms
//     of rows that reach the step's last cell are the step's, computed once
//     per block with the same expressions;
//   fold — the step's thread (the first 128) adds the tile's rows, in row
//     order, into a [nout, G, 128] accumulator that only it touches (the
//     current group's sums in registers), so the per-step fold order is the
//     row order and there are no atomics.
// So every per-item expression and the per-step fold order are those of a
// thread that walks every row in order: the partials are bit for bit the
// same, whatever the tile. Raw f32 staging is double-buffered: the 16-byte
// cp.async copies of tile k+1 and of its rows' n and gid (4-byte copies
// where the view is not aligned) are in flight while tile k is worked; the
// ring above does the same over a half or a quarter of the bytes for
// every narrow variant. A block writes its chunk's partials to scratch;
// fold_chunks then sums the chunks in index order (the TPU grid
// accumulated tiles in order; blocks here run in parallel, so the
// cross-block sum is a second pass, never float atomics; fold.cuh, shared
// with K2). What remains: the tile phases all four variants share (TMA,
// warp specialisation).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fold.cuh"

namespace {

constexpr int kSteps = 128;     // steps per block (K1_STEPS in ops/fusedgrid.py)
constexpr int kThreads = 256;   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;        // cells a thread decodes (K1_RUN)
constexpr int kPasses = 2;      // delta decode passes a tile (K1_PASSES)
constexpr int kMaxRuns = 64;    // delta runs a row (K1_MAX_RUNS): three warps

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
  int vec4;              // raw: 16-byte copies are aligned
  int cw;                // quant16/delta16/delta8: the ring's copy width
                         // in bytes (16, 8 or 4: cp.async; 2 or 1: plain
                         // loads)
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

// cp.async: a copy from device to shared memory that the issuing thread
// does not wait for; commit closes a group of them, wait_group<N> waits
// until at most N of the thread's groups are still in flight
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
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

// raw f32: issues the copies of the tile (16 bytes where the view is
// aligned, 4 otherwise) and of its rows' n and gid, without waiting for them
__device__ __forceinline__ void stage_raw_async(const Params& p, float* tile,
                                                int* n, int* gid, int r0,
                                                int nr, int tid) {
  const float* val = static_cast<const float*>(p.val);
  const int c0 = p.c0;
  if (p.vec4) {
    const int ca4 = p.ca >> 2;
    for (int i = tid; i < nr * ca4; i += kThreads) {
      const int r = i / ca4;
      const int c4 = i - r * ca4;
      cp_async16(tile + r * p.ca + 4 * c4,
                 val + (long long)(r0 + r) * p.row_stride + c0 + 4 * c4);
    }
  } else {
    for (int i = tid; i < nr * p.ca; i += kThreads) {
      const int r = i / p.ca;
      const int c = i - r * p.ca;
      cp_async4(tile + i, val + (long long)(r0 + r) * p.row_stride + c0 + c);
    }
  }
  for (int r = tid; r < nr; r += kThreads) {
    cp_async4(n + r, p.n + r0 + r);
    cp_async4(gid + r, p.gid + r0 + r);
  }
}

// delta16 / delta8. A tile's rows are staged as they are stored, packed
// [nr, ca] in one stage of a two-stage ring; tile k + 1's copies are in
// flight while tile k is decoded and worked. Each thread copies the run of
// cells it decodes (below), so it reads only what its own copies wrote:
// cp.async.wait_group makes them visible to it without a barrier. The copy
// width cw divides the block's base address, its row stride and its row
// length in bytes (the wrapper's delta_copy_width), so every run's global
// and shared starts are cw-aligned.
__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

// The decode's layout: a thread takes run j, cells [cs, ce) = [16 j,
// 16 j + 16), of row q of each pass; nrun runs a row, rpp whole rows a
// pass, at most kPasses passes a tile and kMaxRuns runs a row (the launch
// checks both). The row starts at the pass's thread tid - j.
struct RunSlot {
  int q, j, cs, ce, rpp;
};

__device__ __forceinline__ RunSlot run_slot(int ca, int tid) {
  const int nrun = (ca + kRun - 1) / kRun;
  RunSlot u;
  u.q = tid / nrun;
  u.j = tid - u.q * nrun;
  u.cs = u.j * kRun;
  u.ce = min(u.cs + kRun, ca);
  u.rpp = kThreads / nrun;
  return u;
}

// issues the copies of this thread's runs of rows [r0, r0 + nr) and of the
// rows' n and gid without waiting for them; below 4 bytes (an odd-length
// i8 row, an i16 row at an odd element offset) the cells take plain loads
template <typename T>
__device__ __forceinline__ void stage_delta_async(const Params& p,
                                                  unsigned char* stage,
                                                  int* n, int* gid, int r0,
                                                  int nr, const RunSlot& u,
                                                  int tid) {
  const int L = p.ca * (int)sizeof(T);                 // a row's bytes
  const long long sb = p.row_stride * (long long)sizeof(T);
  const int o0 = u.cs * (int)sizeof(T);
  const int nb = (u.ce - u.cs) * (int)sizeof(T);       // the run's bytes
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps) {
    const int r = ps * u.rpp + u.q;
    if (u.q < u.rpp && r < nr) {
      const char* src =
          static_cast<const char*>(p.val) + (long long)(r0 + r) * sb + o0;
      unsigned char* dst = stage + r * L + o0;
      if (p.cw == 16) {
        for (int o = 0; o < nb; o += 16) cp_async_cg16(dst + o, src + o);
      } else if (p.cw == 8) {
        for (int o = 0; o < nb; o += 8) cp_async8(dst + o, src + o);
      } else if (p.cw == 4) {
        for (int o = 0; o < nb; o += 4) cp_async4(dst + o, src + o);
      } else {
        for (int o = 0; o < nb; o += (int)sizeof(T))
          *reinterpret_cast<T*>(dst + o) =
              *reinterpret_cast<const T*>(src + o);
      }
    }
  }
  for (int r = tid; r < nr; r += kThreads) {
    cp_async4(n + r, p.n + r0 + r);
    cp_async4(gid + r, p.gid + r0 + r);
  }
}

// the anchor of this thread's row of pass ps in rows [r0, r0 + nr)
__device__ __forceinline__ float delta_anchor(const Params& p, int r0, int nr,
                                              const RunSlot& u, int ps) {
  const int r = ps * u.rpp + u.q;
  return u.q < u.rpp && r < nr ? __ldg(p.row0 + r0 + r) : 0.f;
}

// The cells of a run come in four groups of four (one word of i8, two of
// i16). group_prefix(w, i, c): c plus the group's cells 0..i, one dot
// product; group_sum(w): all four.
template <typename T>
__device__ __forceinline__ int group_prefix(const unsigned* w, int i, int c) {
  if constexpr (sizeof(T) == 1) {
    return __dp4a((int)w[0], (int)(0x01010101u >> (8 * (3 - i))), c);
  } else {
    const int lo = __dp2a_lo((int)w[0], i == 0 ? 0x0001 : 0x0101, c);
    return i < 2 ? lo : __dp2a_lo((int)w[1], i == 2 ? 0x0001 : 0x0101, lo);
  }
}

template <typename T>
__device__ __forceinline__ int group_sum(const unsigned* w) {
  return group_prefix<T>(w, 3, 0);
}

// The one-pass decode of a staged tile into the f32 tile: every thread
// sums its run in int32; a segmented scan over the block (the rows are the
// segments: warp shuffles, then the warps' totals through s_scan; a row
// starts j threads back, so no flags travel) gives each run the sum of its
// row's cells before it; each cell is then anchor + (float)prefix. The
// prefixes are exact integers (the encoder keeps them within 2^23; a pool
// row's garbage stays within 2^31), so the one rounding is the anchor add,
// as in the plain anchor + cumsum. A whole
// run goes out as four 16-byte stores, step j writing group (j + rot) % 4
// with rot = (lane / 2 + lane / 8) % 4: the eight threads of a quarter
// warp then write eight different bank groups, and the group reloads of a
// step (lanes 8 apart for i8, 4 apart for i16) hit different banks.
template <typename T>
__device__ __forceinline__ void decode_delta(const Params& p,
                                             const unsigned char* stage,
                                             float* tile, int* s_scan,
                                             int r0, int nr,
                                             const RunSlot& u, float anchor0,
                                             int tid, int lane, int warp) {
  constexpr int kGroupWords = (int)sizeof(T);   // 4 cells, in words
  const int ca = p.ca;
  const int L = ca * (int)sizeof(T);
  const int cs = u.cs, ce = u.ce;           // the run's cells [cs, ce)
  const int rot = ((lane >> 1) + (lane >> 3)) & 3;
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps) {
    if (ps * u.rpp < nr) {                  // uniform over the block
      const int r = ps * u.rpp + u.q;
      const bool act = u.q < u.rpp && r < nr;
      // a whole run in 16-byte words (cw = 16: ca is a multiple of 8 for
      // i16 and of 16 for i8, so the row and the f32 tile row are aligned)
      const bool vec = act && p.cw == 16 && ce - cs == kRun;
      const T* src = reinterpret_cast<const T*>(stage + r * L);
      const unsigned* words = reinterpret_cast<const unsigned*>(src + cs);
      int before[4];                        // cells of the run before group
      int v = 0;
      if (vec) {
#pragma unroll
        for (int k = 0; k < (int)sizeof(T); ++k) {
          const uint4 x = reinterpret_cast<const uint4*>(words)[k];
          const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int h = 0; h < 4 / (int)sizeof(T); ++h) {
            before[k * 4 / (int)sizeof(T) + h] = v;
            v += group_sum<T>(w + h * kGroupWords);
          }
        }
      } else if (act) {
        for (int c = cs; c < ce; ++c) v += (int)src[c];
      }
      // segmented inclusive scan over the warp: s sums the runs of this
      // row from max(its start, the warp's first lane) to this lane
      int s = v;
      const int back = min(u.j, lane);      // runs of the row before, here
      for (int off = 1; off < 32; off <<= 1) {
        const int s_up = __shfl_up_sync(0xffffffffu, s, off);
        if (back >= off) s += s_up;
      }
      int* wsum = s_scan + ps * kWarps;
      if (lane == 31) wsum[warp] = s;
      __syncthreads();
      if (act) {
        int pre = s - v;                    // the row's cells before cs
        // and the warps back to the one the row starts in: a row is at
        // most kMaxRuns = 64 runs, so at most two warps back
        const int w0 = (tid - u.j) >> 5;
        if (w0 < warp) pre += wsum[warp - 1];
        if (w0 < warp - 1) pre += wsum[warp - 2];
        float* dst = tile + r * ca;
        // the first pass's anchor came a tile ahead; a second pass (a few
        // column counts) loads its own
        const float a = ps == 0 ? anchor0 : delta_anchor(p, r0, nr, u, ps);
        if (vec) {
          // the groups' starting prefixes rotated by rot (two conditional
          // swaps); each step then reloads its group's words
#pragma unroll
          for (int g = 0; g < 4; ++g) before[g] += pre;
#pragma unroll
          for (int bit = 2; bit >= 1; bit >>= 1) {
            int b2[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              b2[g] = rot & bit ? before[(g + bit) & 3] : before[g];
#pragma unroll
            for (int g = 0; g < 4; ++g) before[g] = b2[g];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int g = (j + rot) & 3;
            unsigned w[kGroupWords];
            if constexpr (sizeof(T) == 1) {
              w[0] = words[g];
            } else {
              const uint2 x = reinterpret_cast<const uint2*>(words)[g];
              w[0] = x.x;
              w[1] = x.y;
            }
            float4 y;
            y.x = a + (float)group_prefix<T>(w, 0, before[j]);
            y.y = a + (float)group_prefix<T>(w, 1, before[j]);
            y.z = a + (float)group_prefix<T>(w, 2, before[j]);
            y.w = a + (float)group_prefix<T>(w, 3, before[j]);
            reinterpret_cast<float4*>(dst + cs)[g] = y;
          }
        } else {
          for (int c = cs; c < ce; ++c) {
            pre += (int)src[c];
            dst[c] = a + (float)pre;
          }
        }
      }
    }
  }
}

// quant16. A tile's rows are staged as they are stored, packed [nr, ca] in
// one stage of a two-stage ring of i16, and tile k + 1's copies are in
// flight while tile k is dequantised and worked, as for the delta
// variants. The layout is flat: the packed tile is cut into chunks of e =
// cw / 2 cells (one copy of cw bytes; cw divides a row's bytes, so a chunk
// is one row's), and chunk u belongs to thread u % kThreads in pass u /
// kThreads, so a warp's copies are consecutive in the row and in the
// stage. Each thread dequantises the chunks it copied, so only
// cp.async.wait_group stands between the two. A chunk's place in the
// packed stage and in the packed f32 tile is its first cell x = u e; its
// row and column in the block, which the copy and the row operands need,
// step by a fixed amount from pass to pass (QSlot). At 16-byte copies a
// fusable tile (rt Ca <= 4096 cells) takes at most two passes, whose rows'
// vmin and scale are loaded with the copies, a tile ahead; later passes
// (narrower copies) load their own.
struct QSlot {
  int r, c;     // row and column of this thread's chunk of pass 0
  int dr, dc;   // a pass's step, kThreads e cells, in rows and columns
};

__device__ __forceinline__ QSlot quant16_slot(const Params& p, int tid) {
  const int e = p.cw >> 1;
  QSlot u;
  u.r = tid * e / p.ca;
  u.c = tid * e - u.r * p.ca;
  u.dr = kThreads * e / p.ca;
  u.dc = kThreads * e - u.dr * p.ca;
  return u;
}

__device__ __forceinline__ void quant16_next(QSlot& u, int ca) {
  u.c += u.dc;
  u.r += u.dr;
  if (u.c >= ca) {
    u.c -= ca;
    ++u.r;
  }
}

// the vmin and scale of the rows of this thread's chunks of passes 0 and 1
struct QRows {
  float vmin0, scale0, vmin1, scale1;
};

// one chunk's copy (cw = 2: a plain load)
__device__ __forceinline__ void quant16_copy(const Params& p,
                                             unsigned char* dst,
                                             const int16_t* src) {
  if (p.cw == 16) {
    cp_async_cg16(dst, src);
  } else if (p.cw == 8) {
    cp_async8(dst, src);
  } else if (p.cw == 4) {
    cp_async4(dst, src);
  } else {
    *reinterpret_cast<int16_t*>(dst) = *src;
  }
}

// issues the copies of this thread's chunks of rows [r0, r0 + nr) and of
// the rows' n and gid without waiting for them, and loads the vmin and
// scale of its rows of passes 0 and 1
__device__ __forceinline__ QRows stage_quant16_async(const Params& p,
                                                     unsigned char* stage,
                                                     int* n, int* gid,
                                                     int r0, int nr, QSlot u,
                                                     int tid) {
  const int16_t* q = static_cast<const int16_t*>(p.val) + p.c0
                     + (long long)r0 * p.row_stride;
  const int e = p.cw >> 1;
  const int cells = nr * p.ca;
  const int x0 = tid * e;
  const int x1 = x0 + kThreads * e;
  QRows w = {0.f, 0.f, 0.f, 0.f};
  if (x0 < cells) {
    quant16_copy(p, stage + 2 * x0, q + (long long)u.r * p.row_stride + u.c);
    w.vmin0 = __ldg(p.row0 + r0 + u.r);
    w.scale0 = __ldg(p.row1 + r0 + u.r);
  }
  quant16_next(u, p.ca);
  if (x1 < cells) {
    quant16_copy(p, stage + 2 * x1, q + (long long)u.r * p.row_stride + u.c);
    w.vmin1 = __ldg(p.row0 + r0 + u.r);
    w.scale1 = __ldg(p.row1 + r0 + u.r);
  }
  for (int x = x1 + kThreads * e; x < cells; x += kThreads * e) {
    quant16_next(u, p.ca);
    quant16_copy(p, stage + 2 * x, q + (long long)u.r * p.row_stride + u.c);
  }
  for (int r = tid; r < nr; r += kThreads) {
    cp_async4(n + r, p.n + r0 + r);
    cp_async4(gid + r, p.gid + r0 + r);
  }
  return w;
}

// (float)q + 32768.f of the stored i16 q, given its 16 bits h, without a
// conversion instruction (I2F runs at a fraction of the f32 rate): the
// biased value u = q + 32768 in [0, 65535] is h with its top bit flipped,
// and the f32 whose bits are 0x4B000000 | u is 2^23 + u exactly, so
// taking 2^23 away leaves u, exactly what the conversion and the exact add
// give
__device__ __forceinline__ float q_biased(unsigned h) {
  return __int_as_float(h ^ 0x4B008000u) - 8388608.f;
}

// the reference's expression in its order, one rounding each
// (filodb_tpu/ops/decodereg.py::decode_quant16): vmin + ((float)q +
// 32768) * scale, the first add exact
__device__ __forceinline__ float dequant16(unsigned h, float vmin,
                                           float scale) {
  return vmin + q_biased(h) * scale;
}

// the four cells of two 32-bit words, little end first
__device__ __forceinline__ float4 dequant4(unsigned w0, unsigned w1,
                                           float vmin, float scale) {
  float4 y;
  y.x = dequant16(w0 & 0xFFFFu, vmin, scale);
  y.y = dequant16(w0 >> 16, vmin, scale);
  y.z = dequant16(w1 & 0xFFFFu, vmin, scale);
  y.w = dequant16(w1 >> 16, vmin, scale);
  return y;
}

// an 8-cell chunk as two 16-byte stores, lanes 4-7 of each quarter warp
// writing their second half first: the eight lanes' first (and second)
// stores then hit eight different bank groups (lane l at 16-byte group
// 2 l + ((l >> 2) & 1) mod 8)
__device__ __forceinline__ void dequant8(float* dst, const uint4& v,
                                         float vmin, float scale, int h) {
  reinterpret_cast<float4*>(dst)[h] =
      dequant4(h ? v.z : v.x, h ? v.w : v.y, vmin, scale);
  reinterpret_cast<float4*>(dst)[h ^ 1] =
      dequant4(h ? v.x : v.z, h ? v.y : v.w, vmin, scale);
}

// one chunk of e < 8 cells
__device__ __forceinline__ void dequant_narrow(float* dst,
                                               const unsigned char* src,
                                               int e, float vmin,
                                               float scale) {
  if (e == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    *reinterpret_cast<float4*>(dst) = dequant4(v.x, v.y, vmin, scale);
  } else if (e == 2) {
    const unsigned v = *reinterpret_cast<const unsigned*>(src);
    float2 y;
    y.x = dequant16(v & 0xFFFFu, vmin, scale);
    y.y = dequant16(v >> 16, vmin, scale);
    *reinterpret_cast<float2*>(dst) = y;
  } else {
    dst[0] = dequant16(*reinterpret_cast<const uint16_t*>(src), vmin, scale);
  }
}

// The dequantise of this thread's chunks of a staged tile into the f32
// tile (packed [nr, ca] like the stage, so chunk x's cells are at tile +
// x). At 16-byte copies both passes' stage words are read before either
// is dequantised.
__device__ __forceinline__ void dequant_quant16(const Params& p,
                                                const unsigned char* stage,
                                                float* tile, int r0, int nr,
                                                QSlot u, const QRows& w,
                                                int tid, int lane) {
  const int e = p.cw >> 1;
  const int cells = nr * p.ca;
  const int x0 = tid * e;
  const int x1 = x0 + kThreads * e;
  if (e == 8) {
    const bool a0 = x0 < cells, a1 = x1 < cells;
    uint4 v0 = {0u, 0u, 0u, 0u}, v1 = v0;
    if (a0) v0 = *reinterpret_cast<const uint4*>(stage + 2 * x0);
    if (a1) v1 = *reinterpret_cast<const uint4*>(stage + 2 * x1);
    const int h = (lane >> 2) & 1;     // the half this lane stores first
    if (a0) dequant8(tile + x0, v0, w.vmin0, w.scale0, h);
    if (a1) dequant8(tile + x1, v1, w.vmin1, w.scale1, h);
  } else {
    if (x0 < cells)
      dequant_narrow(tile + x0, stage + 2 * x0, e, w.vmin0, w.scale0);
    if (x1 < cells)
      dequant_narrow(tile + x1, stage + 2 * x1, e, w.vmin1, w.scale1);
  }
  quant16_next(u, p.ca);
  for (int x = x1 + kThreads * e; x < cells; x += kThreads * e) {
    quant16_next(u, p.ca);
    const float vmin = __ldg(p.row0 + r0 + u.r);
    const float scale = __ldg(p.row1 + r0 + u.r);
    if (e == 8) {
      dequant8(tile + x, *reinterpret_cast<const uint4*>(stage + 2 * x),
               vmin, scale, (lane >> 2) & 1);
    } else {
      dequant_narrow(tile + x, stage + 2 * x, e, vmin, scale);
    }
  }
}

// The time terms of one (step, row) window, tile_contrib's expressions:
// they depend on the row only through its last cell l_idx, and every row
// whose samples reach the step's last cell (l_idx = hi) has the same ones,
// so those are computed once per step (Terms in shared memory) and only
// shorter rows compute their own
struct Terms {
  float dur_start, dur_end, sampled, avg_dur, thresh, half_avg;
};
constexpr int kTerms = 6;     // floats of Terms

__device__ __forceinline__ Terms time_terms(const Params& p, int f_idx,
                                            int l_idx, int rel_t) {
  const float cnt_f = (float)max(l_idx - f_idx + 1, 0);
  const float relf = (float)rel_t;
  const float f_rel = (float)(f_idx * p.interval_ms);
  const float l_rel = (float)(l_idx * p.interval_ms);
  Terms t;
  t.dur_start = (f_rel - (relf - (float)p.window_ms)) / 1000.0f;
  t.dur_end = (relf - l_rel) / 1000.0f;
  t.sampled = (l_rel - f_rel) / 1000.0f;
  t.avg_dur = t.sampled / (cnt_f - 1.0f);
  t.thresh = t.avg_dur * 1.1f;
  t.half_avg = t.avg_dur / 2.0f;
  return t;
}

// The window walks, ascending over the cells. With kCount they also count
// the non-finite terms they add; a row with no non-finite cell (count 0,
// the usual case) needs no count, since only a row count above the
// window's turns the sum into NaN.
template <bool kCount>
__device__ __forceinline__ float closed_sum(const float* v, int cs, int ce,
                                            int c0, int& nf_in) {
  float s = 0.f;
#pragma unroll 4
  for (int c = cs; c <= ce; ++c) {
    const float x = v[c - c0];
    s = s + x;
    if (kCount) nf_in += !isfinite(x);
  }
  return s;
}

// inc @ band_open: the predecessor's value is carried in a register (the
// same subtraction as v[c] - v[c - 1])
template <bool kCount>
__device__ __forceinline__ float open_delta(const float* v, int cs, int ce,
                                            int c0, bool counter,
                                            int& nf_in) {
  float delta = 0.f;
  if (cs > ce) return delta;
  float prev = v[cs - c0 - 1];
#pragma unroll 4
  for (int c = cs; c <= ce; ++c) {
    const float x = v[c - c0];
    float d = x - prev;
    if (counter) d = relu_keep_nan(d);
    prev = x;
    delta = delta + d;
    if (kCount) nf_in += !isfinite(d);
  }
  return delta;
}

// One (row, step) item: the row's contribution to the step and its presence
// (1 or 0), tile_contrib's expressions in tile_contrib's order. v is the
// row's staged tile row (cell c at v[c - c0]); nfv / nfi its non-finite
// value and increment counts; terms the step's Terms for full rows (stride
// kSteps).
__device__ __forceinline__ void item_contrib(
    const Params& p, const float* v, int n_s, int nfv, int nfi, int lo_t,
    int hi_t, int rel_t, const float* terms, bool window_fn, bool counter,
    float& contrib, float& okf) {
  const int c0 = p.c0;
  const int f_idx = max(lo_t, 0);
  const int vend = min(c0 + p.ca, n_s);      // valid active cells [c0, vend)
  const int l_idx = min(hi_t, n_s - 1);
  const int cnt = max(l_idx - f_idx + 1, 0);
  const float cnt_f = (float)cnt;
  int nf_in = 0;
  if (window_fn) {
    const bool ok = cnt >= 1;
    if (p.fn == FN_COUNT_OVER_TIME) {
      contrib = ok ? cnt_f : 0.f;
    } else {
      // v @ band_closed: cells lo_t <= c <= hi_t
      const int cs = max(lo_t, c0);
      const int ce = min(hi_t, vend - 1);
      float s = nfv ? closed_sum<true>(v, cs, ce, c0, nf_in)
                    : closed_sum<false>(v, cs, ce, c0, nf_in);
      if (nfv > nf_in) s = NAN;
      if (p.fn == FN_AVG_OVER_TIME) s = s / cnt_f;
      contrib = ok ? s : 0.f;
    }
    okf = ok ? 1.f : 0.f;
    return;
  }
  // inc @ band_open: cells lo_t < c <= hi_t with a valid predecessor
  const int cs = max(lo_t + 1, c0 + 1);
  const int ce = min(hi_t, vend - 1);
  float delta = nfi ? open_delta<true>(v, cs, ce, c0, counter, nf_in)
                    : open_delta<false>(v, cs, ce, c0, counter, nf_in);
  if (nfi > nf_in) delta = NAN;
  // v @ onehot_lo: the first sample, 0 outside the valid active cells
  const int p_first = min(f_idx, p.cap - 1);  // one-hot row of the first sample
  const bool in = p_first >= c0 && p_first < vend;
  const float x = in ? v[p_first - c0] : 0.f;
  const int nf_out = nfv - ((in && !isfinite(x)) ? 1 : 0);
  const float f_v = nf_out > 0 ? NAN : x;

  Terms t;
  if (l_idx == hi_t) {
    t.dur_start = terms[0];
    t.dur_end = terms[kSteps];
    t.sampled = terms[2 * kSteps];
    t.avg_dur = terms[3 * kSteps];
    t.thresh = terms[4 * kSteps];
    t.half_avg = terms[5 * kSteps];
  } else {
    t = time_terms(p, f_idx, l_idx, rel_t);
  }
  float dur_start = t.dur_start;
  if (counter) {
    const float safe = delta > 0.f ? delta : 1.0f;
    const float q = f_v / safe;
    const float dur_zero = delta > 0.f ? t.sampled * q : INFINITY;
    if (delta > 0.f && f_v >= 0.f && dur_zero < dur_start)
      dur_start = dur_zero;
  }
  float extrap = t.sampled;
  extrap = extrap + (dur_start < t.thresh ? dur_start : t.half_avg);
  extrap = extrap + (t.dur_end < t.thresh ? t.dur_end : t.half_avg);
  float scaled = delta * (extrap / t.sampled);
  if (p.fn == FN_RATE) scaled = scaled * p.rate_scale;
  const bool ok = cnt >= 2;
  contrib = ok ? scaled : 0.f;
  okf = ok ? 1.f : 0.f;
}

// Shared memory of one block, in this order (k1_smem_bytes in
// ops/fusedgrid.py mirrors the sum; keep the two alike):
//   f32 tile buffers [nbuf, rt, ca]  (nbuf: 2 for raw, 1 for the others)
//   quant16/delta16/delta8: the ring [2, rt, ca] of the block's own
//       type, its bytes rounded up to 4 (raw's second f32 buffer is at
//       least as large, and exactly as large for the i16 kinds, so no
//       block asks for more than raw's)
//   f32 contributions [rt, kSteps], presence [rt, kSteps] (the delta
//       decode's scan words while the tile is staged)
//   f32 accumulator [nout, G, kSteps]
//   f32 the steps' Terms of full rows [kTerms, kSteps]
//   i32 n, gid [2, rt] each (beside the two buffers or stages), non-finite
//       values, non-finite increments [rt] each
//   i32 lo, hi, rel, live-step list [kSteps] each; live steps per warp [4]
__host__ __device__ constexpr int tile_buffers(int kind) {
  return kind == KIND_RAW ? 2 : 1;
}

__host__ __device__ constexpr int ring_bytes(int kind, int rt, int ca) {
  return kind == KIND_QUANT16 || kind == KIND_DELTA16 ? 4 * rt * ca
         : kind == KIND_DELTA8 ? (2 * rt * ca + 3) / 4 * 4 : 0;
}

size_t smem_bytes(int kind, int rt, int ca, int groups, int nout) {
  return sizeof(float) * ((size_t)tile_buffers(kind) * rt * ca
                          + 2 * (size_t)rt * kSteps
                          + (size_t)nout * groups * kSteps
                          + (size_t)kTerms * kSteps)
         + ring_bytes(kind, rt, ca)
         + sizeof(int) * (6 * (size_t)rt + 4 * kSteps + 4);
}

template <int K>
__device__ __forceinline__ void fused_grid_body(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  const int tsz = p.rt * p.ca;
  const int G = p.groups;
  float* bufs = smem;                                   // [nbuf, rt, ca]
  unsigned char* ring =                                 // ring: [2, rt, ca]
      reinterpret_cast<unsigned char*>(bufs + tile_buffers(K) * tsz);
  float* s_con = bufs + tile_buffers(K) * tsz           // [rt, kSteps]
                 + ring_bytes(K, p.rt, p.ca) / 4;
  float* s_okf = s_con + p.rt * kSteps;                 // [rt, kSteps]
  float* acc = s_okf + p.rt * kSteps;                   // [nout, G, kSteps]
  float* s_terms = acc + p.nout * G * kSteps;           // [kTerms, kSteps]
  int* s_nb = reinterpret_cast<int*>(s_terms + kTerms * kSteps);  // [2, rt]
  int* s_gb = s_nb + 2 * p.rt;    // [2, rt]: n and gid beside each buffer
  int* s_nfv = s_gb + 2 * p.rt;   // non-finite valid values per staged row
  int* s_nfi = s_nfv + p.rt;      // non-finite increments per staged row
  int* s_lo = s_nfi + p.rt;       // the chunk's step operands
  int* s_hi = s_lo + kSteps;
  int* s_rel = s_hi + kSteps;
  int* s_step = s_rel + kSteps;   // the live steps' local indices, ascending
  int* s_wlive = s_step + kSteps; // live steps in each of the first 4 warps

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row_end = min(row0 + p.rows_per_block, p.rows);
  const bool window_fn = p.fn >= FN_SUM_OVER_TIME;
  const bool counter = p.fn == FN_RATE || p.fn == FN_INCREASE;
  const bool sumsq = p.nout == 3;

  for (int i = tid; i < p.nout * G * kSteps; i += kThreads) acc[i] = 0.f;

  // the chunk's steps; hi < 0 gives cnt = 0 for every row (nothing to add),
  // so only the live ones become items, listed once here
  bool live = false;
  unsigned live_mask = 0;
  if (tid < kSteps) {               // warps 0-3, whole
    const int t = blockIdx.y * kSteps + tid;
    const int hi_t = p.hi[t];
    s_lo[tid] = p.lo[t];
    s_hi[tid] = hi_t;
    s_rel[tid] = p.rel[t];
    live = hi_t >= 0;
    if (!window_fn) {
      const Terms tt = time_terms(p, max(s_lo[tid], 0), hi_t, s_rel[tid]);
      s_terms[tid] = tt.dur_start;
      s_terms[kSteps + tid] = tt.dur_end;
      s_terms[2 * kSteps + tid] = tt.sampled;
      s_terms[3 * kSteps + tid] = tt.avg_dur;
      s_terms[4 * kSteps + tid] = tt.thresh;
      s_terms[5 * kSteps + tid] = tt.half_avg;
    }
    live_mask = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_wlive[warp] = __popc(live_mask);
  }
  __syncthreads();
  const int nlive = s_wlive[0] + s_wlive[1] + s_wlive[2] + s_wlive[3];
  if (live) {
    int base = 0;
    for (int w = 0; w < warp; ++w) base += s_wlive[w];
    s_step[base + __popc(live_mask & ((1u << lane) - 1u))] = tid;
  }

  if constexpr (K == KIND_RAW) {     // the first tile's copies
    if (nlive > 0 && row0 < row_end)
      stage_raw_async(p, bufs, s_nb, s_gb, row0, min(p.rt, row_end - row0),
                      tid);
    cp_async_commit();
  }
  using DeltaT = typename std::conditional<K == KIND_DELTA8, int8_t,
                                           int16_t>::type;
  constexpr bool kDelta = K == KIND_DELTA16 || K == KIND_DELTA8;
  const int stage_bytes = p.rt * p.ca * (int)sizeof(DeltaT);
  const RunSlot slot = run_slot(p.ca, tid);
  int* s_scan = reinterpret_cast<int*>(s_con);
  float anchor = 0.f;                // the tile's first-pass anchor, a tile
                                     // ahead
  if constexpr (kDelta) {            // the first tile's copies and anchor
    if (nlive > 0 && row0 < row_end) {
      const int nr = min(p.rt, row_end - row0);
      stage_delta_async<DeltaT>(p, ring, s_nb, s_gb, row0, nr, slot, tid);
      anchor = delta_anchor(p, row0, nr, slot, 0);
    }
    cp_async_commit();
  }
  const QSlot qslot = quant16_slot(p, tid);
  QRows qrows = {0.f, 0.f, 0.f, 0.f};  // the tile's vmin and scale, a tile
                                       // ahead
  if constexpr (K == KIND_QUANT16) {   // the first tile's copies and rows
    if (nlive > 0 && row0 < row_end) {
      const int nr = min(p.rt, row_end - row0);
      qrows = stage_quant16_async(p, ring, s_nb, s_gb, row0, nr, qslot, tid);
    }
    cp_async_commit();
  }
  float* a_sum = acc;
  float* a_cnt = acc + G * kSteps;
  float* a_sq = acc + 2 * G * kSteps;
  int cg = -1;                          // the group held in registers
  float c_sum = 0.f, c_cnt = 0.f, c_sq = 0.f;
  int k = 0;
  for (int r0 = row0; nlive > 0 && r0 < row_end; r0 += p.rt, ++k) {
    const int nr = min(p.rt, row_end - r0);
    __syncthreads();   // the previous tile, its items and its fold are done
    const int b = k & 1;
    float* tile = bufs + (K == KIND_RAW ? b * tsz : 0);
    int* s_n = s_nb + b * p.rt;
    int* s_gid = s_gb + b * p.rt;
    float next = 0.f;                  // delta: tile k + 1's anchor
    QRows qnext = {0.f, 0.f, 0.f, 0.f};  // quant16: tile k + 1's rows
    if constexpr (K == KIND_RAW) {
      // tile k + 1's copies go out into the other buffers (their last
      // readers, tile k - 1's items and fold, passed the barrier above);
      // then wait for tile k's
      const int r1 = r0 + p.rt;
      if (r1 < row_end)
        stage_raw_async(p, bufs + (b ^ 1) * tsz, s_nb + (b ^ 1) * p.rt,
                        s_gb + (b ^ 1) * p.rt, r1, min(p.rt, row_end - r1),
                        tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else if constexpr (K == KIND_QUANT16) {
      // the same for the quant16 ring: tile k + 1's chunks (this thread's
      // own), n and gid, and its rows' vmin and scale into registers; then
      // wait for this thread's copies of tile k and dequantise them
      const int r1 = r0 + p.rt;
      if (r1 < row_end) {
        const int nr1 = min(p.rt, row_end - r1);
        qnext = stage_quant16_async(p, ring + (b ^ 1) * stage_bytes,
                                    s_nb + (b ^ 1) * p.rt,
                                    s_gb + (b ^ 1) * p.rt, r1, nr1, qslot,
                                    tid);
      }
      cp_async_commit();
      cp_async_wait<1>();
      dequant_quant16(p, ring + b * stage_bytes, tile, r0, nr, qslot, qrows,
                      tid, lane);
    } else {
      // the same for the ring: tile k + 1's runs (this thread's own: their
      // last reader, its decode of tile k - 1, is behind it), n and gid
      // (their last readers, tile k - 1's fold, passed the barrier above)
      // and, into a register, its first-pass anchor; then wait for this
      // thread's copies of tile k and decode them (the decode's barrier
      // makes n and gid visible before the phases below read them)
      const int r1 = r0 + p.rt;
      if (r1 < row_end) {
        const int nr1 = min(p.rt, row_end - r1);
        stage_delta_async<DeltaT>(p, ring + (b ^ 1) * stage_bytes,
                                  s_nb + (b ^ 1) * p.rt,
                                  s_gb + (b ^ 1) * p.rt, r1, nr1, slot, tid);
        next = delta_anchor(p, r1, nr1, slot, 0);
      }
      cp_async_commit();
      cp_async_wait<1>();
      decode_delta<DeltaT>(p, ring + b * stage_bytes, tile, s_scan, r0, nr,
                           slot, anchor, tid, lane, warp);
    }
    __syncthreads();
    // per-row count of non-finite cells the band products multiply by 0:
    // values in [c0, vend) and increments in [c0 + 1, vend). A row whose
    // valid cells all lie in (-2^126, 2^126) has no non-finite value and no
    // non-finite increment (|x - y| < 2^127), so both counts are 0 without
    // counting; only a row with a cell outside (NaN, +-Inf or huge) is
    // counted cell by cell
    for (int r = warp; r < nr; r += kWarps) {
      const float* v = tile + r * p.ca;
      const int vend = min(p.c0 + p.ca, s_n[r]);
      int nfv = 0, nfi = 0;
      bool wide = false;
      for (int c = p.c0 + lane; c < vend; c += 32)
        wide |= !(fabsf(v[c - p.c0]) < 0x1p126f);
      if (__any_sync(0xffffffffu, wide)) {
        for (int c = p.c0 + lane; c < vend; c += 32) {
          nfv += !isfinite(v[c - p.c0]);
          if (!window_fn && c > p.c0)
            nfi += !isfinite(inc_of(v, c - p.c0, counter));
        }
        for (int off = 16; off > 0; off >>= 1) {
          nfv += __shfl_xor_sync(0xffffffffu, nfv, off);
          nfi += __shfl_xor_sync(0xffffffffu, nfi, off);
        }
      }
      if (lane == 0) {
        s_nfv[r] = nfv;
        s_nfi[r] = nfi;
      }
    }
    __syncthreads();

    // contributions: (row, live step) items over the whole block,
    // consecutive threads on consecutive steps of one row
    for (int i = tid; i < nr * nlive; i += kThreads) {
      const int r = i / nlive;
      const int j = s_step[i - r * nlive];
      float contrib, okf;
      item_contrib(p, tile + r * p.ca, s_n[r], s_nfv[r], s_nfi[r], s_lo[j],
                   s_hi[j], s_rel[j], s_terms + j, window_fn, counter,
                   contrib, okf);
      s_con[r * kSteps + j] = contrib;
      s_okf[r * kSteps + j] = okf;
    }
    __syncthreads();

    // fold: the step's thread adds the tile's rows in row order; one-hot
    // fold: row -> its group, and a non-finite term times 0 is NaN in every
    // other group's sum. The running sums of the last row's group stay in
    // registers (cg) and go back to the accumulator only when a row of
    // another group comes: the same additions in the same order, without a
    // shared-memory round trip per row while the group stays the same
    if (live) {
      for (int r = 0; r < nr; ++r) {
        const float contrib = s_con[r * kSteps + tid];
        const float okf = s_okf[r * kSteps + tid];
        const int g = s_gid[r];
        const bool in_g = g >= 0 && g < G;
        if (in_g && g != cg) {
          if (cg >= 0) {
            a_sum[cg * kSteps + tid] = c_sum;
            a_cnt[cg * kSteps + tid] = c_cnt;
            if (sumsq) a_sq[cg * kSteps + tid] = c_sq;
          }
          cg = g;
          c_sum = a_sum[g * kSteps + tid];
          c_cnt = a_cnt[g * kSteps + tid];
          if (sumsq) c_sq = a_sq[g * kSteps + tid];
        }
        if (in_g) {
          c_sum += contrib;
          c_cnt += okf;
        }
        if (!isfinite(contrib)) {
          for (int k = 0; k < G; ++k) {
            if (k == g) continue;
            if (k == cg) c_sum += NAN;
            else a_sum[k * kSteps + tid] += NAN;
          }
        }
        if (sumsq) {
          const float sq = contrib * contrib;
          if (in_g) c_sq += sq;
          if (!isfinite(sq)) {
            for (int k = 0; k < G; ++k) {
              if (k == g) continue;
              if (k == cg) c_sq += NAN;
              else a_sq[k * kSteps + tid] += NAN;
            }
          }
        }
      }
    }
    if constexpr (kDelta) {   // used a tile later: the loads have long landed
      anchor = next;
    }
    if constexpr (K == KIND_QUANT16) {
      qrows = qnext;
    }
  }
  if (cg >= 0) {
    a_sum[cg * kSteps + tid] = c_sum;
    a_cnt[cg * kSteps + tid] = c_cnt;
    if (sumsq) a_sq[cg * kSteps + tid] = c_sq;
  }
  if (tid < kSteps) {     // only this thread touched its step's accumulator
    const int t = blockIdx.y * kSteps + tid;
    float* out = p.scratch + (size_t)blockIdx.x * p.nout * G * p.tp;
    for (int o = 0; o < p.nout; ++o)
      for (int g = 0; g < G; ++g)
        out[(size_t)(o * G + g) * p.tp + t] = acc[(o * G + g) * kSteps + tid];
  }
}

// The kernels: raw as it was; the ring variants (quant16, delta16,
// delta8) held to 64 registers, so four blocks still fit an SM
template <int K>
__global__ void __launch_bounds__(kThreads)
fused_grid_map(Params p) {
  fused_grid_body<K>(p);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 4)
fused_grid_map_ring(Params p) {
  fused_grid_body<K>(p);
}

template <int K>
cudaError_t launch_map(const Params& p, dim3 grid, cudaStream_t s) {
  void (*kernel)(Params);
  if constexpr (K == KIND_RAW)
    kernel = fused_grid_map<K>;
  else
    kernel = fused_grid_map_ring<K>;
  const size_t smem = smem_bytes(K, p.rt, p.ca, p.groups, p.nout);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fusedgrid_launch(
    const void* val, int kind, const float* row0, const float* row1,
    long long row_stride, int c0, int ca, int cap, int rows,
    const int* n, const int* gid, const int* lo, const int* hi, const int* rel,
    int tp, int groups, int fn, int nout, int window_ms, int interval_ms,
    float rate_scale, int rows_per_block, int rt, int vec4, int cw,
    float* scratch, int nchunks, float* out, void* stream) {
  // the ring variants copy with a width that divides the first active
  // byte, the row stride and the row length in bytes; the delta variants
  // decode from cell 0 of the whole row, at most kMaxRuns runs a row and
  // kPasses passes a tile
  if (kind != KIND_RAW) {
    const int esz = kind == KIND_DELTA8 ? 1 : 2;
    const uintptr_t first =
        reinterpret_cast<uintptr_t>(val) + (uintptr_t)c0 * esz;
    const bool width = (cw == 1 || cw == 2 || cw == 4 || cw == 8 || cw == 16)
                       && cw >= esz && (ca * esz) % cw == 0
                       && (row_stride * esz) % cw == 0 && first % cw == 0;
    if (ca < 1 || !width) return (int)cudaErrorInvalidValue;
  }
  if (kind == KIND_DELTA16 || kind == KIND_DELTA8) {
    const int nrun = (ca + kRun - 1) / kRun;
    const int rpp = nrun > 0 ? kThreads / nrun : 0;
    if (c0 != 0 || ca != cap || nrun > kMaxRuns || rt > kPasses * rpp)
      return (int)cudaErrorInvalidValue;
  }
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
  p.cw = cw;
  p.scratch = scratch;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(nchunks, tp / kSteps);
  cudaError_t err;
  switch (kind) {
    case KIND_RAW: err = launch_map<KIND_RAW>(p, grid, s); break;
    case KIND_QUANT16: err = launch_map<KIND_QUANT16>(p, grid, s); break;
    case KIND_DELTA16: err = launch_map<KIND_DELTA16>(p, grid, s); break;
    case KIND_DELTA8: err = launch_map<KIND_DELTA8>(p, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold(scratch, out, nchunks, nout * groups * tp, s);
}

extern "C" const char* fusedgrid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
