// Device code shared by the scan's cooperative kernels: wide_step.cu (K2,
// the wide steps of gramtools_tpu/mapping/search_jax_log.py::
// _build_log_step) and locked_step.cu (K3, the hole-allocated and the
// slot-locked narrow steps of _build_narrow_step).
//
// Both run one thread a pool slot in tiles of kThreads slots and split a
// step into stages by grid syncs (all but K3's slot-locked steps, which
// take none: locked_step.cu). What they share:
//   * the index tables (Index) and the occ-row fetch, from the dense
//     (n + 1, 4) table or through K1's per-row count (packed_rank.cuh);
//   * lf_extend: the LF extension of [lo, hi] by one base and the marker
//     counts at both ends (scan_steps._lf_extend);
//   * block_scan / block_sum: the pieces of a grid-wide exclusive scan
//     (tile sums written before a grid sync, each block sums the earlier
//     tiles itself, then scans its own tile with warp shuffles), so every
//     rank equals the integer cumsum the torch twin takes;
//   * resize: _resize_pool on the double-buffered carry;
//   * stage (c), own_hits: start_of, the spilled flag and the (G,) hit ->
//     state table of the global hit enumeration;
//   * stage (d), hit_pair: one (hit g, outcome b) pair's owner (JAX's
//     owner search, the empty hit slots included), its jump locus, the
//     genealogy log record written in place, and the newborn's LF.
// Every clamp of the JAX code is kept; its dropped writes write nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_rank.cuh"

namespace scan_dev {

constexpr int kThreads = 256;             // slots a tile, threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// per-slot flags
constexpr int kValid = 1, kActive = 2, kSingle = 4, kWide = 8, kKeep = 16,
              kSpillW = 32, kSpilled = 64;

// the DeviceIndex tables a step reads
struct Index {
  const int* narrow_tab;      // (n,), or a stub the wide step never reads
  int n;
  const int4* occ;            // dense (n + 1, 4), or null
  const uint4* blocks;        // packed records, or null
  const int* sym_start;       // (>= 5,)
  const int* sentinel_row;    // ()
  const int* mrl;             // (n_mrl,) marker rank -> jump locus
  int n_mrl;
  const int* out_lo;          // (L, B)
  const int* out_hi;
  int L;
  int B;
};

// one buffer of the double-buffered carry: four fields of ``stride`` ints
struct Carry {
  int* rid;
  int* lo;
  int* hi;
  int* pref;
};

__device__ __forceinline__ Carry carry_at(int* carry, int buf, int stride) {
  int* b = carry + (size_t)buf * 4 * stride;
  return Carry{b, b + stride, b + 2 * (size_t)stride, b + 3 * (size_t)stride};
}

__host__ __device__ inline int n_tiles(long long count) {
  return (int)((count + kThreads - 1) / kThreads);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int32 addition that wraps as the torch and XLA int32 ops do
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// channel `base` (1-4) of an occ row; 0 for any other base (one-hot)
__device__ __forceinline__ int chan(int4 v, int base) {
  return base == 1 ? v.x : base == 2 ? v.y : base == 3 ? v.z
                         : base == 4 ? v.w : 0;
}

__device__ __forceinline__ int4 occ_row(const Index& x, int r) {
  if (x.blocks != nullptr) return packed_rank_dev::rank_row(x.blocks, r, x.n);
  return __ldg(x.occ + clampi(r, 0, x.n));
}

// Exclusive scan of v over the block's threads; *total gets the block's
// sum. Every thread of the block calls it.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  const int out = (warp == 0 ? 0 : warp_sums[warp - 1]) + x - v;
  __syncthreads();                 // warp_sums is reused by the next call
  return out;
}

// sum of a[0:count) (written by other blocks before a grid sync), by the
// whole block
__device__ int block_sum(const int* a, int count) {
  int s = 0;
  for (int i = threadIdx.x; i < count; i += kThreads) s += a[i];
  int total;
  block_scan(s, &total);
  return total;
}

// The block's exclusive scan of v with the earlier tiles' sums added (the
// rank of tile ``tile`` in slot order); *tile_total gets the tile's sum.
__device__ __forceinline__ int grid_rank(const int* sums, int tile, int v,
                                         int* tile_total) {
  const int off = block_sum(sums, tile);
  return off + block_scan(v, tile_total);
}

// LF extension of [lo, hi] by base and the marker counts in bwt[0:lo) and
// bwt[0:hi + 1) (markers = i - #dna(< i) - #sentinel(< i))
struct LF {
  int nlo, nhi, mlo, mhi;
};

__device__ __forceinline__ LF lf_extend(const Index& x, int lo, int hi,
                                        int base, int sent) {
  const int hi1 = add_wrap(hi, 1);
  const int4 rl = occ_row(x, lo), rh = occ_row(x, hi1);
  const int first = __ldg(x.sym_start + clampi(base, 0, 4));
  LF out;
  out.nlo = first + chan(rl, base);
  out.nhi = first + chan(rh, base) - 1;
  out.mlo = lo - (rl.x + rl.y + rl.z + rl.w) - (lo > sent ? 1 : 0);
  out.mhi = hi1 - (rh.x + rh.y + rh.z + rh.w) - (hi1 > sent ? 1 : 0);
  return out;
}

// _resize_pool on carry buffer b, from n_from live-packed slots to n_to:
// slots past n_to flag their read (a slot without a read sets the dump
// slot R, as the twin's scatter does); new slots get (-1, 0, 0, 0). Every
// thread of the grid calls it.
__device__ void resize(Carry b, int n_from, int n_to, int R,
                       unsigned char* ovf) {
  const int count = n_from > n_to ? n_from : n_to;
  bool dump = false;
  for (int tile = blockIdx.x; tile < n_tiles(count); tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    if (i >= n_to && i < n_from) {
      const int r = b.rid[i];
      if (r < 0) dump = true;
      else if (r <= R) ovf[r] = 1;
    } else if (i >= n_from && i < n_to) {
      b.rid[i] = -1;
      b.lo[i] = 0;
      b.hi[i] = 0;
      b.pref[i] = 0;
    }
  }
  if (__syncthreads_or(dump) && threadIdx.x == 0) ovf[R] = 1;
}

// The per-slot fields the hit stages read and write
struct Slots {
  int* flags;     // per slot
  int* base;
  int* cnt;       // marker hits of the slot's extension
  int* hit;       // hitfield: marker rank (wide) or jump locus (single)
  int* start;     // start_of
  int* table;     // (G,) hit -> owning state
  int* csum;      // (tiles,) cnt sum a tile
  int* last;      // () the last state with hits in the budget
};

// stage (c) for slot i with its exclusive start_of: the spilled flag; a
// state with cnt > 0 and start_of < G owns hits [start_of, min(start_of +
// cnt, G)) and writes itself into the table; the last such state is kept
// apart for the empty hit slots
__device__ __forceinline__ void own_hits(const Slots& sl, int i, int cnt,
                                         int start, int total, int G) {
  const int cum = start + cnt;
  sl.start[i] = start;
  const int f = sl.flags[i];
  if ((f & kActive) && cum > G && cnt > 0) sl.flags[i] = f | kSpilled;
  if (cnt > 0 && start < G) {
    const int end = cnt > G - start ? G : start + cnt;
    for (int g = start; g < end; ++g) sl.table[g] = i;
    if (cum == total) *sl.last = i;
  }
}

// one newborn candidate of stage (d)
struct Birth {
  int s;          // the owning state (its slot)
  int lo, hi;     // the newborn's interval
  bool ok;        // a valid newborn (locus, outcome and interval)
};

// stage (d) for hit pair k = g·B + b of a step with budget G and total
// hits: the owner s (the last state with cnt > 0, or state 0 when total ==
// 0, for g >= min(total, G), as the JAX owner search gives), its jump
// locus (direct for a single state, marker_rank_locus for a wide one),
// the log record (pref[s], li·B + b) at log_base + k, the empty slots
// included, and the LF of the newborn by the owner's base
__device__ __forceinline__ Birth hit_pair(const Index& x, const Slots& sl,
                                          const int* pref, int k, int G,
                                          int total, int log_base, int* lp,
                                          int* le) {
  const int B = x.B;
  const int g = k / B, b = k - g * B;
  const int hits_ok = total < G ? total : G;
  Birth out;
  out.s = g < hits_ok ? sl.table[g] : (total == 0 ? 0 : *sl.last);
  out.ok = false;
  int loc = -1;
  if (g < hits_ok) {
    const int hf = sl.hit[out.s];
    loc = (sl.flags[out.s] & kSingle)
              ? hf
              : __ldg(x.mrl + clampi(add_wrap(hf, g - sl.start[out.s]), 0,
                                     x.n_mrl - 1));
  }
  const int li = clampi(loc, 0, x.L - 1);
  lp[log_base + k] = pref[out.s];
  le[log_base + k] = li * B + b;
  if (loc < 0) return out;
  const int j_lo = __ldg(x.out_lo + li * B + b);
  if (j_lo < 0) return out;
  const int j_hi1 = add_wrap(__ldg(x.out_hi + li * B + b), 1);
  const int jb = sl.base[out.s];
  const int4 rl = occ_row(x, j_lo), rh = occ_row(x, j_hi1);
  const int first = __ldg(x.sym_start + clampi(jb, 0, 4));
  out.lo = first + chan(rl, jb);
  out.hi = first + chan(rh, jb) - 1;
  out.ok = out.lo <= out.hi;
  return out;
}

// the blocks of ``kernel`` co-resident on the current device (queried once
// a device into ``cache``), no more than ``need``; -(CUDA error) on failure
template <class Kernel>
int coop_grid(Kernel kernel, int* cache, int need) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 0 || dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return -(int)err;
    if (per_sm * sms < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  need = need < 1 ? 1 : need;
  return need < cache[dev] ? need : cache[dev];
}

}  // namespace scan_dev
