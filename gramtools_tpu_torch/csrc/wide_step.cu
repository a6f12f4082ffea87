// The scan's wide steps on Hopper (sm_90a): every wide phase of a buffer's
// plan, with _resize_pool between phases, in one cooperative launch.
//
// Replaces gramtools_tpu/mapping/search_jax_log.py::_resize_pool and
// _build_log_step stepped by lax.scan over each wide phase (the warm and
// mid phases, and the wide tail that auto_phases plans without the narrow
// step), which the TPU runs as XLA-lowered jnp (they are not Pallas
// kernels), together with the ops/prefix.py::mm_cumsum prefix sums of each
// step and its packed-rank occ gathers (gramtools_tpu/ops/rank.py::
// _rank_kernel, K1; packed_rank.cuh). In eager PyTorch one wide step is
// ~200 launches; here the 6 wide steps of a buffer are one launch.
//
// The carry (read_id, lo, hi, pref) is double-buffered in ``carry`` (2, 4,
// C), C >= every pool size and the incoming pool: a step reads one buffer
// and writes the other; the inputs are never written. ``ovf`` (R + 1,)
// gets the input flags (the last entry is the scan's dump slot) ORed with
// every flag the steps raise, and the dump slot wherever the twin's
// scatter routes an unflagged entry there (every wide step does).
//
// The incoming pool is copied into buffer 0; each phase resizes the pool
// to its size N (scan_common.cuh), then runs its steps, four stages a
// step split by grid syncs (one thread a slot, tiles of kThreads slots):
//   (a) rid = clamp(read_id), base = reads[s, rid] where valid, active;
//       an active state LF-extends [lo, hi] with two occ rows (dense table
//       or packed records) and counts the markers at both ends; keep,
//       kept_lo/hi, cnt; each tile's cnt and keep counts;
//   (c) start_of and the (G,) hit -> state table (own_hits);
//   (d) one thread a (hit g, outcome b) pair (hit_pair): the log record
//       written in place, the newborn candidate kept at k = g·B + b; each
//       tile's candidate count;
//   (e) the dense repack: a survivor of keep rank r goes to slot r, the
//       candidate of rank c to slot n_keep + c, or flags its read past N;
//       slots past n_keep + n_cand take (-1, 0, 0, 0); spilled states
//       flag their read.
// The two exclusive scans of (e) are the one scan over the N + G·B flags
// of the JAX step, split at N.
//
// What bounds it on the card: the warm steps' random occ-row reads (two a
// state, two a newborn, 16 or 32 bytes each) and the grid syncs. Design:
// as locked_step.cu, the grid is at most the co-resident blocks and no more
// than the work needs; a block loops over its tiles.
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers and PyTorch's current stream; wide_steps returns the
// launch's CUDA error, 0 on success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace scan_dev;

constexpr int kMaxPhases = 16;

struct Params {
  Index x;
  const int* rid_in;          // (n_in,) carry in, never written
  const int* lo_in;
  const int* hi_in;
  const int* pref_in;
  const unsigned char* ovf_in;   // (R + 1,)
  int n_in;
  const int* reads;           // (sum of steps, R)
  int R;
  int n_phases;
  int steps[kMaxPhases];
  int pool[kMaxPhases];
  int hits[kMaxPhases];
  int log_base;
  int* lp;                    // the whole log
  int* le;
  int* carry;                 // (2, 4, C)
  int C;
  unsigned char* ovf;         // (R + 1,)
  int* scratch;               // scratch_ints(C, K, G_max)
};

__host__ __device__ inline long long scratch_ints(int C, int K, int g_max) {
  return 7LL * C + 4LL * K + g_max + 2LL * n_tiles(C) + n_tiles(K) + 1;
}

struct Scratch {
  Slots sl;       // flags, base, cnt, hit, start, table, csum, last
  int* klo;       // kept_lo / kept_hi
  int* khi;
  int* hsum;      // (tiles,) survivors a tile
  int* cand;      // (K,) newborn candidates
  int* elo;
  int* ehi;
  int* crid;
  int* ksum;      // (tiles of K,) candidates a tile
};

__device__ Scratch scratch_of(const Params& p, int g_max) {
  Scratch s;
  const int C = p.C, K = g_max * p.x.B;
  int* q = p.scratch;
  int** per_slot[] = {&s.sl.flags, &s.sl.base, &s.sl.cnt, &s.sl.hit,
                      &s.sl.start, &s.klo, &s.khi};
  for (int** f : per_slot) { *f = q; q += C; }
  int** per_pair[] = {&s.cand, &s.elo, &s.ehi, &s.crid};
  for (int** f : per_pair) { *f = q; q += K; }
  s.sl.table = q; q += g_max;
  s.sl.csum = q; q += n_tiles(C);
  s.hsum = q; q += n_tiles(C);
  s.ksum = q; q += n_tiles(K);
  s.sl.last = q;
  return s;
}

// One wide step over N slots, cur -> nxt (port of _build_log_step); the
// grid is synchronised before it.
__device__ void wide_step(const Params& p, const Scratch& sc, Carry cur,
                          Carry nxt, const int* row, int N, int G,
                          int log_base, cg::grid_group& grid) {
  const int R = p.R, GB = G * p.x.B;
  const int T = n_tiles(N), TK = n_tiles(GB);
  const int sent = __ldg(p.x.sentinel_row);

  // ---- (a) LF of every active state, keep, cnt ---------------------------
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    int cnt = 0, keep = 0;
    if (i < N) {
      const int rid = cur.rid[i], lo = cur.lo[i], hi = cur.hi[i];
      const bool valid = rid >= 0;
      const int base = valid ? __ldg(row + clampi(rid, 0, R - 1)) : 0;
      const bool active = valid && base > 0;
      int klo = lo, khi = hi, mlo = 0;
      bool alive = false;
      if (active) {
        const LF lf = lf_extend(p.x, lo, hi, base, sent);
        klo = lf.nlo;
        khi = lf.nhi;
        mlo = lf.mlo;
        cnt = lf.mhi - lf.mlo;
        alive = lf.nlo <= lf.nhi;
      }
      keep = (active && alive) || (valid && !active) ? 1 : 0;
      sc.sl.flags[i] = (valid ? kValid : 0) | (active ? kActive : 0)
                       | (keep ? kKeep : 0);
      sc.sl.base[i] = base;
      sc.sl.cnt[i] = cnt;
      sc.sl.hit[i] = mlo;
      sc.klo[i] = klo;
      sc.khi[i] = khi;
    }
    int total;
    block_scan(cnt, &total);
    if (threadIdx.x == 0) sc.sl.csum[tile] = total;
    block_scan(keep, &total);
    if (threadIdx.x == 0) sc.hsum[tile] = total;
  }
  grid.sync();

  // ---- (c) hit enumeration ----------------------------------------------
  const int total = block_sum(sc.sl.csum, T);
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    const int cnt = i < N ? sc.sl.cnt[i] : 0;
    int tile_total;
    const int start = grid_rank(sc.sl.csum, tile, cnt, &tile_total);
    if (i < N) own_hits(sc.sl, i, cnt, start, total, G);
  }
  grid.sync();

  // ---- (d) hits x outcomes: log records, newborn candidates --------------
  for (int tile = blockIdx.x; tile < TK; tile += gridDim.x) {
    const int k = tile * kThreads + threadIdx.x;
    int c = 0;
    if (k < GB) {
      const Birth nb = hit_pair(p.x, sc.sl, cur.pref, k, G, total, log_base,
                                p.lp, p.le);
      if (nb.ok) {
        c = 1;
        sc.elo[k] = nb.lo;
        sc.ehi[k] = nb.hi;
        sc.crid[k] = clampi(cur.rid[nb.s], 0, R - 1);
      }
      sc.cand[k] = c;
    }
    int tile_total;
    block_scan(c, &tile_total);
    if (threadIdx.x == 0) sc.ksum[tile] = tile_total;
  }
  grid.sync();

  // ---- (e) dense repack: survivors, then newborns, then the fill ---------
  const int n_keep = block_sum(sc.hsum, T);
  const int n_cand = block_sum(sc.ksum, TK);
  const int n_fill = n_keep + n_cand < N ? n_keep + n_cand : N;
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    const int f = i < N ? sc.sl.flags[i] : 0;
    int tile_total;
    const int pos = grid_rank(sc.hsum, tile, (f & kKeep) ? 1 : 0,
                              &tile_total);
    if (i >= N) continue;
    const int rid = cur.rid[i];
    if (f & kKeep) {                              // pos < n_keep <= N
      nxt.rid[pos] = rid;
      nxt.lo[pos] = sc.klo[i];
      nxt.hi[pos] = sc.khi[i];
      nxt.pref[pos] = cur.pref[i];
    }
    if (f & kSpilled) p.ovf[clampi(rid, 0, R - 1)] = 1;
    if (i >= n_fill) {
      nxt.rid[i] = -1;
      nxt.lo[i] = 0;
      nxt.hi[i] = 0;
      nxt.pref[i] = 0;
    }
  }
  for (int tile = blockIdx.x; tile < TK; tile += gridDim.x) {
    const int k = tile * kThreads + threadIdx.x;
    const int c = k < GB ? sc.cand[k] : 0;
    int tile_total;
    const int pos = n_keep + grid_rank(sc.ksum, tile, c, &tile_total);
    if (!c) continue;
    if (pos < N) {
      nxt.rid[pos] = sc.crid[k];
      nxt.lo[pos] = sc.elo[k];
      nxt.hi[pos] = sc.ehi[k];
      nxt.pref[pos] = log_base + k;
    } else {
      p.ovf[sc.crid[k]] = 1;                      // a dropped newborn
    }
  }
  // the twin's scatter routes every unflagged entry to the dump slot, and
  // a step with N >= 1 slots always has one
  if (blockIdx.x == 0 && threadIdx.x == 0) p.ovf[R] = 1;
}

__global__ void __launch_bounds__(kThreads)
wide_steps_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  int g_max = 1;
  for (int ph = 0; ph < p.n_phases; ++ph) g_max = max(g_max, p.hits[ph]);
  const Scratch sc = scratch_of(p, g_max);
  const int R = p.R, C = p.C;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;

  // ---- the incoming pool and flags copied in ----------------------------
  {
    const Carry b = carry_at(p.carry, 0, C);
    for (int i = tid; i < p.n_in; i += nthreads) {
      b.rid[i] = __ldg(p.rid_in + i);
      b.lo[i] = __ldg(p.lo_in + i);
      b.hi[i] = __ldg(p.hi_in + i);
      b.pref[i] = __ldg(p.pref_in + i);
    }
    for (int i = tid; i <= R; i += nthreads) p.ovf[i] = p.ovf_in[i];
  }
  int buf = 0, n_cur = p.n_in, log_base = p.log_base;
  const int* row = p.reads;
  for (int ph = 0; ph < p.n_phases; ++ph) {
    const int N = p.pool[ph], G = p.hits[ph];
    grid.sync();
    if (N != n_cur) {
      resize(carry_at(p.carry, buf, C), n_cur, N, R, p.ovf);
      n_cur = N;
      grid.sync();
    }
    for (int s = 0; s < p.steps[ph]; ++s) {
      if (s > 0) grid.sync();
      wide_step(p, sc, carry_at(p.carry, buf, C),
                carry_at(p.carry, buf ^ 1, C), row, N, G, log_base, grid);
      buf ^= 1;
      row += R;
      log_base += G * p.x.B;
    }
  }
}

// co-resident blocks of the kernel on each device, queried once
int g_max_blocks[kMaxDevices];

}  // namespace

extern "C" int wide_steps_max_phases() { return kMaxPhases; }

extern "C" long long wide_steps_scratch(int C, int K, int g_max) {
  return scratch_ints(C, K, g_max);
}

// The grid the launch will use for C slots and K hit pairs: at most the
// blocks co-resident on the current device (queried once a device), no
// more than the work needs. Returns -(CUDA error) on failure.
extern "C" int wide_steps_grid(int C, int K) {
  return coop_grid(wide_steps_kernel, g_max_blocks,
                   max(n_tiles(C), n_tiles(K)));
}

extern "C" int wide_steps(
    const void* rid_in, const void* lo_in, const void* hi_in,
    const void* pref_in, const void* ovf_in, int n_in,
    const void* reads, int R, int n_phases, const int* steps,
    const int* pool, const int* hits,
    const void* occ, const void* blocks, int n,
    const void* sym_start, const void* sentinel_row,
    const void* mrl, int n_mrl, const void* out_lo, const void* out_hi,
    int L, int B, int log_base, void* lp, void* le,
    void* carry, int C, void* ovf, void* scratch, int grid, void* stream) {
  if (n_phases < 0 || n_phases > kMaxPhases)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x.narrow_tab = nullptr;
  p.x.n = n;
  p.x.occ = static_cast<const int4*>(occ);
  p.x.blocks = static_cast<const uint4*>(blocks);
  p.x.sym_start = static_cast<const int*>(sym_start);
  p.x.sentinel_row = static_cast<const int*>(sentinel_row);
  p.x.mrl = static_cast<const int*>(mrl);
  p.x.n_mrl = n_mrl;
  p.x.out_lo = static_cast<const int*>(out_lo);
  p.x.out_hi = static_cast<const int*>(out_hi);
  p.x.L = L;
  p.x.B = B;
  p.rid_in = static_cast<const int*>(rid_in);
  p.lo_in = static_cast<const int*>(lo_in);
  p.hi_in = static_cast<const int*>(hi_in);
  p.pref_in = static_cast<const int*>(pref_in);
  p.ovf_in = static_cast<const unsigned char*>(ovf_in);
  p.n_in = n_in;
  p.reads = static_cast<const int*>(reads);
  p.R = R;
  p.n_phases = n_phases;
  for (int ph = 0; ph < kMaxPhases; ++ph) {
    p.steps[ph] = ph < n_phases ? steps[ph] : 0;
    p.pool[ph] = ph < n_phases ? pool[ph] : 0;
    p.hits[ph] = ph < n_phases ? hits[ph] : 0;
  }
  p.log_base = log_base;
  p.lp = static_cast<int*>(lp);
  p.le = static_cast<int*>(le);
  p.carry = static_cast<int*>(carry);
  p.C = C;
  p.ovf = static_cast<unsigned char*>(ovf);
  p.scratch = static_cast<int*>(scratch);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)wide_steps_kernel, dim3(grid), dim3(kThreads), args, 0,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
