// The slot-locked scan tail on Hopper (sm_90a): lock the pool, then run a
// range of slot-locked narrow scan steps, all in one cooperative launch.
//
// Replaces gramtools_tpu/mapping/search_jax_log.py::_lock_pool and
// _build_narrow_step(locked=True) stepped by lax.scan, which the TPU
// runs as XLA-lowered jnp (they are not Pallas kernels), together with
// the three ops/prefix.py::mm_cumsum prefix sums of each step and its
// packed-rank occ gathers (gramtools_tpu/ops/rank.py::_rank_kernel, K1;
// packed_rank.cuh). In eager PyTorch one locked step is ~200 launches;
// at 150 bp reads and k = 10 the tail is 126 steps of a 140-step scan,
// so ~26,000 launches a buffer whose enqueue outlasts their device time
// tenfold. Here the whole tail is one launch.
//
// Pool slot i IS read i (R slots). The carry (read_id, lo, hi, pref) is
// double-buffered in ``carry`` (2, 4, R): step s reads buffer s % 2 and
// writes (s+1) % 2; the inputs are never written. ``ovf`` (R + 1,) gets
// the input flags (the last entry is the scan's dump slot, copied
// through) ORed with every flag the lock and the steps raise.
//
// Lock (``lock`` != 0; _lock_pool): count each read's live states into
// a zeroed (R,) scratch; a read with one state gets it in its slot, a
// read with more is flagged; the other slots hold (-1, 0, 0, 0). With
// ``lock`` == 0 the input is a locked carry and is copied in.
//
// One step (one thread a slot, tiles of kThreads slots; stages split by
// grid syncs, four a step):
//   (a) valid, base = reads[s, i], active, single = lo == hi; the
//       narrow_tab word t (sym = t >> 24, val = t & 0xFFFFFF);
//       wide = active & !single; each tile's wide count;
//   (b) the exclusive wide rank in slot order (tile sums, then a block
//       scan); a wide state of rank < W LF-extends [lo, hi] with two occ
//       rows (dense table or packed records) and counts the markers at
//       both ends (_lf_extend); keep, kept_lo/hi, cnt, hitfield, spill_w;
//       each tile's cnt sum;
//   (c) start_of = the exclusive scan of cnt, total; spilled; each state
//       with cnt > 0 and start_of < G owns hits [start_of, min(start_of +
//       cnt, G)) and writes itself into the (G,) hit -> state table; the
//       last such state is kept apart for the empty hit slots;
//   (d) one thread a (hit g, outcome b) pair: the hit's state s (the
//       last state with cnt > 0, or state 0 when total == 0, for g >=
//       min(total, G), as the JAX owner search gives), its jump locus
//       (direct for a single state, marker_rank_locus for a wide one),
//       the outcome bounds and the LF of the newborn by the parent's
//       base; the log record (pref[s], li * B + b) goes straight to
//       log_base + s·G·B + g·B + b, the empty slots included; a valid
//       newborn counts into its read's (N,) scratch and the first one
//       keeps its interval and pref;
//   (e) conflict (two newborns, or one beside a kept parent) clears the
//       slot's read_id; a sole newborn with no kept parent takes the
//       slot; spilled | spill_w | conflict go to ovf; then stage (a) of
//       the next step for the same slot.
// Every clamp of the JAX code is kept; its dropped writes (mode="drop")
// write nothing here.
//
// What bounds it on the card: synchronisation and latency. A step moves
// a few hundred kilobytes (the carry, the reads row, the narrow words,
// the log records) and does a few dozen integer ops a slot, which the
// card does in about a microsecond; each grid sync costs a few
// microseconds. Design: the grid is at most the co-resident blocks
// (queried once per device), no more than the work needs, so a sync is
// a short barrier; the carry and scratch stay in L2.
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers and PyTorch's current stream; locked_tail returns the
// launch's CUDA error, 0 on success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_rank.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;             // slots a tile, threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// per-slot flags (scratch)
constexpr int kValid = 1, kActive = 2, kSingle = 4, kWide = 8, kKeep = 16,
              kSpillW = 32, kSpilled = 64;

struct Params {
  const int* rid_in;          // (n_in,) carry in, never written
  const int* lo_in;
  const int* hi_in;
  const int* pref_in;
  const unsigned char* ovf_in;   // (R + 1,)
  int n_in;
  int lock;
  const int* reads;           // (steps, R)
  int steps;
  int R;
  const int* narrow_tab;      // (n,)
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
  int G;
  int W;
  int log_base;
  int* lp;                    // the whole log
  int* le;
  int* carry;                 // (2, 4, R)
  unsigned char* ovf;         // (R + 1,)
  int* scratch;               // scratch_ints(R, G)
};

__host__ __device__ inline int n_tiles(int R) {
  return (R + kThreads - 1) / kThreads;
}

__host__ __device__ inline long long scratch_ints(int R, int G) {
  return 12LL * R + G + 2LL * n_tiles(R) + 1;
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

__device__ __forceinline__ int4 occ_row(const Params& p, int r) {
  if (p.blocks != nullptr) return packed_rank_dev::rank_row(p.blocks, r, p.n);
  return __ldg(p.occ + clampi(r, 0, p.n));
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

struct Scratch {
  int* flags;     // per slot
  int* base;
  int* t;         // narrow_tab word
  int* cnt;
  int* hit;       // hitfield: marker rank (wide) or jump locus (single)
  int* start;     // start_of
  int* klo;       // kept_lo / kept_hi
  int* khi;
  int* nb_cnt;    // newborns a read (the lock's state count first)
  int* nb_lo;     // the first newborn's interval and pref
  int* nb_hi;
  int* nb_pref;
  int* table;     // (G,) hit -> owning state
  int* wsum;      // (tiles,) wide count a tile
  int* csum;      // (tiles,) cnt sum a tile
  int* last;      // () the last state with hits in the budget
};

__device__ Scratch scratch_of(const Params& p) {
  Scratch s;
  const int R = p.R;
  int* q = p.scratch;
  s.flags = q; q += R;
  s.base = q; q += R;
  s.t = q; q += R;
  s.cnt = q; q += R;
  s.hit = q; q += R;
  s.start = q; q += R;
  s.klo = q; q += R;
  s.khi = q; q += R;
  s.nb_cnt = q; q += R;
  s.nb_lo = q; q += R;
  s.nb_hi = q; q += R;
  s.nb_pref = q; q += R;
  s.table = q; q += p.G;
  s.wsum = q; q += n_tiles(R);
  s.csum = q; q += n_tiles(R);
  s.last = q;
  return s;
}

// stage (a) of slot i for the step whose base row is base_row; returns
// its wide flag
__device__ __forceinline__ int stage_a(const Params& p, const Scratch& sc,
                                       const int* base_row, int i, int rid,
                                       int lo, int hi) {
  const bool valid = rid >= 0;
  const int base = valid ? __ldg(base_row + i) : 0;
  const bool active = valid && base > 0;
  const bool single = lo == hi;
  const int t = __ldg(p.narrow_tab + clampi(lo, 0, p.n - 1));
  const bool wide = active && !single;
  sc.flags[i] = (valid ? kValid : 0) | (active ? kActive : 0)
                | (single ? kSingle : 0) | (wide ? kWide : 0);
  sc.base[i] = base;
  sc.t[i] = t;
  return wide ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
locked_tail_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  const Scratch sc = scratch_of(p);
  const int R = p.R, G = p.G, B = p.B;
  const int T = n_tiles(R);
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const int sent = __ldg(p.sentinel_row);
  int* buf0 = p.carry;

  // ---- the lock (_lock_pool), or a locked carry copied in -------------
  if (p.lock) {
    for (int i = tid; i < R; i += nthreads) sc.nb_cnt[i] = 0;
    grid.sync();
    for (int j = tid; j < p.n_in; j += nthreads) {
      const int r = __ldg(p.rid_in + j);
      if (r >= 0) atomicAdd(sc.nb_cnt + clampi(r, 0, R - 1), 1);
    }
    grid.sync();
    // slot i is written by its placed state or, if none, with the fill:
    // exactly one writer either way
    const int n_all = max(p.n_in, R);
    for (int i = tid; i < n_all; i += nthreads) {
      if (i < R) {
        const int c = sc.nb_cnt[i];
        p.ovf[i] = (p.ovf_in[i] != 0 || c > 1) ? 1 : 0;
        if (c != 1) {
          buf0[i] = -1;
          buf0[R + i] = 0;
          buf0[2 * R + i] = 0;
          buf0[3 * R + i] = 0;
        }
      }
      if (i < p.n_in) {
        const int r = __ldg(p.rid_in + i);
        const int rc = clampi(r, 0, R - 1);
        if (r >= 0 && sc.nb_cnt[rc] == 1) {
          buf0[rc] = rc;
          buf0[R + rc] = __ldg(p.lo_in + i);
          buf0[2 * R + rc] = __ldg(p.hi_in + i);
          buf0[3 * R + rc] = __ldg(p.pref_in + i);
        }
      }
    }
  } else {
    for (int i = tid; i < R; i += nthreads) {
      p.ovf[i] = p.ovf_in[i];
      buf0[i] = __ldg(p.rid_in + i);
      buf0[R + i] = __ldg(p.lo_in + i);
      buf0[2 * R + i] = __ldg(p.hi_in + i);
      buf0[3 * R + i] = __ldg(p.pref_in + i);
    }
  }
  if (tid == 0) p.ovf[R] = p.ovf_in[R];
  if (p.steps == 0) return;
  grid.sync();

  // ---- stage (a) of step 0 ---------------------------------------------
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    int wide = 0;
    if (i < R) wide = stage_a(p, sc, p.reads, i, buf0[i], buf0[R + i],
                              buf0[2 * R + i]);
    int total;
    block_scan(wide, &total);
    if (threadIdx.x == 0) sc.wsum[tile] = total;
  }

  for (int s = 0; s < p.steps; ++s) {
    const int* cur = p.carry + (s & 1) * 4 * R;
    int* nxt = p.carry + ((s + 1) & 1) * 4 * R;
    const int log_base = p.log_base + s * G * B;
    grid.sync();

    // ---- (b) wide rank, LF of the covered wide states, cnt -------------
    for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
      const int i = tile * kThreads + threadIdx.x;
      const bool in = i < R;
      const int f = in ? sc.flags[i] : 0;
      const int tile_off = block_sum(sc.wsum, tile);
      int total;
      const int w_rank = tile_off + block_scan((f & kWide) ? 1 : 0, &total);
      int cnt = 0;
      if (in) {
        const bool valid = f & kValid, active = f & kActive;
        const bool single = f & kSingle, wide = f & kWide;
        const int lo = cur[R + i], hi = cur[2 * R + i];
        const int base = sc.base[i], t = sc.t[i];
        const int sym = t >> 24, val = t & 0xFFFFFF;
        int wlo = 0, whi = 0, wmlo = 0, wmhi = 0;   // wball: 0 unless covered
        if (wide && w_rank < p.W) {
          const int hi1 = add_wrap(hi, 1);
          const int4 rl = occ_row(p, lo), rh = occ_row(p, hi1);
          const int first = __ldg(p.sym_start + clampi(base, 0, 4));
          wlo = first + chan(rl, base);
          whi = first + chan(rh, base) - 1;
          wmlo = lo - (rl.x + rl.y + rl.z + rl.w) - (lo > sent ? 1 : 0);
          wmhi = hi1 - (rh.x + rh.y + rh.z + rh.w) - (hi1 > sent ? 1 : 0);
        }
        const bool covered = single || (wide && w_rank < p.W);
        const bool spill_w = wide && w_rank >= p.W;
        const int nlo = single ? val : wlo;
        const int nhi = single ? val : whi;
        const bool ok = single ? sym == base : wlo <= whi;
        const bool ac = active && covered;
        const bool keep = (ac && ok) || (valid && !active);
        sc.klo[i] = ac ? nlo : lo;
        sc.khi[i] = ac ? nhi : hi;
        cnt = ac ? (single ? (sym == 5 ? 1 : 0) : wmhi - wmlo) : 0;
        sc.cnt[i] = cnt;
        sc.hit[i] = single ? val : wmlo;
        sc.flags[i] = f | (keep ? kKeep : 0) | (spill_w ? kSpillW : 0);
      }
      block_scan(cnt, &total);
      if (threadIdx.x == 0) sc.csum[tile] = total;
    }
    grid.sync();

    // ---- (c) hit enumeration: start_of, total, the hit -> state table --
    const int total = block_sum(sc.csum, T);
    for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
      const int i = tile * kThreads + threadIdx.x;
      const bool in = i < R;
      const int cnt = in ? sc.cnt[i] : 0;
      const int tile_off = block_sum(sc.csum, tile);
      int tile_total;
      const int start = tile_off + block_scan(cnt, &tile_total);
      if (in) {
        const int cum = start + cnt;
        sc.start[i] = start;
        sc.nb_cnt[i] = 0;
        const int f = sc.flags[i];
        if ((f & kActive) && cum > G && cnt > 0) sc.flags[i] = f | kSpilled;
        if (cnt > 0 && start < G) {
          const int end = cnt > G - start ? G : start + cnt;
          for (int g = start; g < end; ++g) sc.table[g] = i;
          if (cum == total) *sc.last = i;
        }
      }
    }
    grid.sync();

    // ---- (d) hits x outcomes: loci, log records, newborns ---------------
    const int hits_ok = min(total, G);
    const int GB = G * B;
    for (int k = tid; k < GB; k += nthreads) {
      const int g = k / B, b = k - g * B;
      const int s_of = g < hits_ok ? sc.table[g] : (total == 0 ? 0 : *sc.last);
      int loc = -1;
      if (g < hits_ok) {
        const int hf = sc.hit[s_of];
        loc = (sc.flags[s_of] & kSingle)
                  ? hf
                  : __ldg(p.mrl + clampi(add_wrap(hf, g - sc.start[s_of]), 0,
                                         p.n_mrl - 1));
      }
      const int li = clampi(loc, 0, p.L - 1);
      p.lp[log_base + k] = cur[3 * R + s_of];
      p.le[log_base + k] = li * B + b;
      if (loc < 0) continue;
      const int j_lo = __ldg(p.out_lo + li * B + b);
      if (j_lo < 0) continue;
      const int j_hi1 = add_wrap(__ldg(p.out_hi + li * B + b), 1);
      const int jb = sc.base[s_of];
      const int4 rl = occ_row(p, j_lo), rh = occ_row(p, j_hi1);
      const int first = __ldg(p.sym_start + clampi(jb, 0, 4));
      const int e_lo = first + chan(rl, jb);
      const int e_hi = first + chan(rh, jb) - 1;
      if (e_lo > e_hi) continue;
      if (atomicAdd(sc.nb_cnt + s_of, 1) == 0) {
        sc.nb_lo[s_of] = e_lo;
        sc.nb_hi[s_of] = e_hi;
        sc.nb_pref[s_of] = log_base + k;
      }
    }
    grid.sync();

    // ---- (e) placement, overflow; then (a) of the next step -------------
    const bool more = s + 1 < p.steps;
    const int* next_row = p.reads + (size_t)(s + 1) * R;
    for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
      const int i = tile * kThreads + threadIdx.x;
      int wide = 0;
      if (i < R) {
        const int f = sc.flags[i];
        const bool keep = f & kKeep;
        const int c = sc.nb_cnt[i];
        const bool conflict = c > 1 || (c == 1 && keep);
        int rid, lo, hi, pref;
        if (c == 1 && !keep) {
          rid = i;
          lo = sc.nb_lo[i];
          hi = sc.nb_hi[i];
          pref = sc.nb_pref[i];
        } else {
          rid = keep ? cur[i] : -1;
          lo = sc.klo[i];
          hi = sc.khi[i];
          pref = cur[3 * R + i];
        }
        if (conflict) rid = -1;
        nxt[i] = rid;
        nxt[R + i] = lo;
        nxt[2 * R + i] = hi;
        nxt[3 * R + i] = pref;
        if (conflict || (f & (kSpillW | kSpilled))) p.ovf[i] = 1;
        if (more) wide = stage_a(p, sc, next_row, i, rid, lo, hi);
      }
      if (more) {
        int total_w;
        block_scan(wide, &total_w);
        if (threadIdx.x == 0) sc.wsum[tile] = total_w;
      }
    }
  }
}

// co-resident blocks of the kernel on each device, queried once
int g_max_blocks[kMaxDevices];

}  // namespace

extern "C" long long locked_tail_scratch(int R, int G) {
  return scratch_ints(R, G);
}

// The grid the launch will use for R slots and G·B hit pairs: at most
// the blocks co-resident on the current device (queried once a device),
// no more than the work needs. Returns -(CUDA error) on failure.
extern "C" int locked_tail_grid(int R, int n_in, int GB) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 0 || dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (g_max_blocks[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, locked_tail_kernel, kThreads, 0);
    if (err != cudaSuccess) return -(int)err;
    if (per_sm * sms < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    g_max_blocks[dev] = per_sm * sms;
  }
  const int need = max(max(n_tiles(R), n_tiles(n_in)), max(n_tiles(GB), 1));
  return min(need, g_max_blocks[dev]);
}

extern "C" int locked_tail(
    const void* rid_in, const void* lo_in, const void* hi_in,
    const void* pref_in, const void* ovf_in, int n_in, int lock,
    const void* reads, int steps, int R,
    const void* narrow_tab, int n, const void* occ, const void* blocks,
    const void* sym_start, const void* sentinel_row,
    const void* mrl, int n_mrl, const void* out_lo, const void* out_hi,
    int L, int B, int G, int W, int log_base, void* lp, void* le,
    void* carry, void* ovf, void* scratch, int grid, void* stream) {
  Params p;
  p.rid_in = static_cast<const int*>(rid_in);
  p.lo_in = static_cast<const int*>(lo_in);
  p.hi_in = static_cast<const int*>(hi_in);
  p.pref_in = static_cast<const int*>(pref_in);
  p.ovf_in = static_cast<const unsigned char*>(ovf_in);
  p.n_in = n_in;
  p.lock = lock;
  p.reads = static_cast<const int*>(reads);
  p.steps = steps;
  p.R = R;
  p.narrow_tab = static_cast<const int*>(narrow_tab);
  p.n = n;
  p.occ = static_cast<const int4*>(occ);
  p.blocks = static_cast<const uint4*>(blocks);
  p.sym_start = static_cast<const int*>(sym_start);
  p.sentinel_row = static_cast<const int*>(sentinel_row);
  p.mrl = static_cast<const int*>(mrl);
  p.n_mrl = n_mrl;
  p.out_lo = static_cast<const int*>(out_lo);
  p.out_hi = static_cast<const int*>(out_hi);
  p.L = L;
  p.B = B;
  p.G = G;
  p.W = W;
  p.log_base = log_base;
  p.lp = static_cast<int*>(lp);
  p.le = static_cast<int*>(le);
  p.carry = static_cast<int*>(carry);
  p.ovf = static_cast<unsigned char*>(ovf);
  p.scratch = static_cast<int*>(scratch);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)locked_tail_kernel, dim3(grid), dim3(kThreads), args, 0,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
