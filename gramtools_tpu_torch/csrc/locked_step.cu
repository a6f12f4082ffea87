// The scan's narrow tail on Hopper (sm_90a): a range of hole-allocated
// narrow steps, the lock, then a range of slot-locked narrow steps, all in
// one cooperative launch.
//
// Replaces gramtools_tpu/mapping/search_jax_log.py::_resize_pool,
// _build_narrow_step(locked=False) stepped by lax.scan, _lock_pool and
// _build_narrow_step(locked=True) stepped by lax.scan, which the TPU runs
// as XLA-lowered jnp (they are not Pallas kernels), together with the
// ops/prefix.py::mm_cumsum prefix sums of each step and its packed-rank occ
// gathers (gramtools_tpu/ops/rank.py::_rank_kernel, K1; packed_rank.cuh).
// In eager PyTorch one narrow step is ~200 launches; at 150 bp reads and k
// = 10 the tail is 8 hole-allocated and 126 slot-locked steps of a
// 140-step scan. Here the whole tail is one launch.
//
// The carry (read_id, lo, hi, pref) is double-buffered in ``carry`` (2, 4,
// C), C >= every pool size: a step reads one buffer and writes the other;
// the inputs are never written. ``ovf`` (R + 1,) gets the input flags (the
// last entry is the scan's dump slot) ORed with every flag the steps
// raise, and the dump slot wherever the twin's scatter routes an unflagged
// entry there.
//
// Start: the incoming pool (n_in states) is copied into buffer 0.
//
// Hole-allocated steps (n_narrow of them, pool Nn, budgets Gn and Wn):
// _resize_pool from n_in to Nn first (scan_common.cuh), then five stages a
// step, split by grid syncs:
//   (a) rid = clamp(read_id), base = reads[s, rid] where valid, active,
//       single = lo == hi; the narrow_tab word t (sym = t >> 24, val = t &
//       0xFFFFFF); wide = active & !single; each tile's wide count;
//   (b) the exclusive wide rank in slot order; a wide state of rank < W
//       LF-extends [lo, hi] with two occ rows (dense table or packed
//       records) and counts the markers at both ends; keep, kept_lo/hi,
//       cnt, hitfield, spill_w; each tile's cnt and hole (!keep) counts;
//   (c) start_of and the hit -> state table (own_hits), and the exclusive
//       hole rank: hole h_rank < HB = G·B writes its slot into the (HB,)
//       slot-of-rank table;
//   (d) one thread a (hit g, outcome b) pair (hit_pair): the log record
//       written in place, the newborn candidate kept at k = g·B + b; each
//       tile's candidate count;
//   (e) the exclusive candidate rank c_rank in (g, b) order; a candidate
//       with c_rank < min(n_holes, HB) takes hole slot_of_rank[c_rank],
//       the others flag their read; every other slot takes its own row
//       (read_id where kept, else -1); spilled | spill_w flag the read.
//
// Lock (``lock`` != 0; _lock_pool): count each read's live states into a
// zeroed (R,) scratch; a read with one state gets it in its slot, a read
// with more is flagged; the other slots hold (-1, 0, 0, 0).
//
// Slot-locked steps (n_locked of them; pool slot i IS read i, R slots),
// four grid syncs a step: stages (a)-(d) as above with rid = i and no
// hole rank, a valid newborn counting into its read's (R,) scratch, the
// first one keeping its interval and pref; then (e): conflict (two
// newborns, or one beside a kept parent) clears the slot's read_id; a sole
// newborn with no kept parent takes the slot; spilled | spill_w | conflict
// go to ovf; then stage (a) of the next step for the same slot.
//
// What bounds it on the card: synchronisation and latency. A step moves a
// few hundred kilobytes (the carry, the reads row, the narrow words, the
// log records) and does a few dozen integer ops a slot, which the card
// does in about a microsecond; each grid sync costs a few microseconds.
// Design: the grid is at most the co-resident blocks (queried once per
// device), no more than the work needs, so a sync is a short barrier; the
// carry and scratch stay in L2.
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers and PyTorch's current stream; locked_tail returns the
// launch's CUDA error, 0 on success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace scan_dev;

struct Params {
  Index x;
  const int* rid_in;          // (n_in,) carry in, never written
  const int* lo_in;
  const int* hi_in;
  const int* pref_in;
  const unsigned char* ovf_in;   // (R + 1,)
  int n_in;
  const int* reads;           // (n_narrow + n_locked, R)
  int R;
  int n_narrow;               // hole-allocated steps
  int Nn;                     // their pool (0: no narrow range), hit and
                              // wide budgets
  int Gn;
  int Wn;
  int lock;
  int n_locked;               // slot-locked steps
  int G;                      // their hit and wide budgets
  int W;
  int log_base;
  int* lp;                    // the whole log
  int* le;
  int* carry;                 // (2, 4, C)
  int C;
  unsigned char* ovf;         // (R + 1,)
  int* scratch;               // scratch_ints(C, K, G_max)
};

__host__ __device__ inline long long scratch_ints(int C, int K, int g_max) {
  return 13LL * C + 5LL * K + g_max + 3LL * n_tiles(C) + n_tiles(K) + 1;
}

struct Scratch {
  Slots sl;       // flags, base, cnt, hit, start, table, csum, last
  int* t;         // narrow_tab word
  int* klo;       // kept_lo / kept_hi
  int* khi;
  int* nb_cnt;    // newborns a read (the lock's state count first)
  int* nb_lo;     // the first newborn's interval and pref
  int* nb_hi;
  int* nb_pref;
  int* hrank;     // hole rank
  int* wsum;      // (tiles,) wide count a tile
  int* hsum;      // (tiles,) hole count a tile
  int* cand;      // (K,) newborn candidates of the hole-allocated step
  int* elo;
  int* ehi;
  int* crid;
  int* slot_of;   // (K,) hole slot of each hole rank < HB
  int* ksum;      // (tiles of K,) candidates a tile
};

__device__ Scratch scratch_of(const Params& p) {
  Scratch s;
  const int C = p.C;
  const int g_max = p.Gn > p.G ? p.Gn : p.G;
  const int K = g_max * p.x.B;
  int* q = p.scratch;
  int** per_slot[] = {&s.sl.flags, &s.sl.base, &s.sl.cnt, &s.sl.hit,
                      &s.sl.start, &s.t, &s.klo, &s.khi, &s.nb_cnt,
                      &s.nb_lo, &s.nb_hi, &s.nb_pref, &s.hrank};
  for (int** f : per_slot) { *f = q; q += C; }
  int** per_pair[] = {&s.cand, &s.elo, &s.ehi, &s.crid, &s.slot_of};
  for (int** f : per_pair) { *f = q; q += K; }
  s.sl.table = q; q += g_max;
  s.sl.csum = q; q += n_tiles(C);
  s.wsum = q; q += n_tiles(C);
  s.hsum = q; q += n_tiles(C);
  s.ksum = q; q += n_tiles(K);
  s.sl.last = q;
  return s;
}

// stage (a) of slot i whose carry row is (rid, lo, hi), for the step whose
// base row is ``row``; returns its wide flag
__device__ __forceinline__ int stage_a(const Params& p, const Scratch& sc,
                                       const int* row, bool locked, int i,
                                       int rid, int lo, int hi) {
  const bool valid = rid >= 0;
  const int at = locked ? i : clampi(rid, 0, p.R - 1);
  const int base = valid ? __ldg(row + at) : 0;
  const bool active = valid && base > 0;
  const bool single = lo == hi;
  const int t = __ldg(p.x.narrow_tab + clampi(lo, 0, p.x.n - 1));
  const bool wide = active && !single;
  sc.sl.flags[i] = (valid ? kValid : 0) | (active ? kActive : 0)
                   | (single ? kSingle : 0) | (wide ? kWide : 0);
  sc.sl.base[i] = base;
  sc.t[i] = t;
  return wide ? 1 : 0;
}

// stage (a) over N slots of carry ``cur``
__device__ void stage_a_all(const Params& p, const Scratch& sc, Carry cur,
                            const int* row, bool locked, int N) {
  for (int tile = blockIdx.x; tile < n_tiles(N); tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    int wide = 0;
    if (i < N) wide = stage_a(p, sc, row, locked, i, cur.rid[i], cur.lo[i],
                              cur.hi[i]);
    int total;
    block_scan(wide, &total);
    if (threadIdx.x == 0) sc.wsum[tile] = total;
  }
}

// stage (b) over N slots: wide rank, LF of the covered wide states, keep,
// cnt; each tile's cnt sum and (holes) hole count
__device__ void stage_b(const Params& p, const Scratch& sc, Carry cur, int N,
                        int W, bool holes) {
  const int sent = __ldg(p.x.sentinel_row);
  for (int tile = blockIdx.x; tile < n_tiles(N); tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    const bool in = i < N;
    const int f = in ? sc.sl.flags[i] : 0;
    int total;
    const int w_rank = grid_rank(sc.wsum, tile, (f & kWide) ? 1 : 0, &total);
    int cnt = 0, hole = 0;
    if (in) {
      const bool valid = f & kValid, active = f & kActive;
      const bool single = f & kSingle, wide = f & kWide;
      const int lo = cur.lo[i], hi = cur.hi[i];
      const int base = sc.sl.base[i], t = sc.t[i];
      const int sym = t >> 24, val = t & 0xFFFFFF;
      LF w = {0, 0, 0, 0};                        // wball: 0 unless covered
      if (wide && w_rank < W) w = lf_extend(p.x, lo, hi, base, sent);
      const bool covered = single || (wide && w_rank < W);
      const bool spill_w = wide && w_rank >= W;
      const bool ok = single ? sym == base : w.nlo <= w.nhi;
      const bool ac = active && covered;
      const bool keep = (ac && ok) || (valid && !active);
      sc.klo[i] = ac ? (single ? val : w.nlo) : lo;
      sc.khi[i] = ac ? (single ? val : w.nhi) : hi;
      cnt = ac ? (single ? (sym == 5 ? 1 : 0) : w.mhi - w.mlo) : 0;
      hole = keep ? 0 : 1;
      sc.sl.cnt[i] = cnt;
      sc.sl.hit[i] = single ? val : w.mlo;
      sc.sl.flags[i] = f | (keep ? kKeep : 0) | (spill_w ? kSpillW : 0);
    }
    block_scan(cnt, &total);
    if (threadIdx.x == 0) sc.sl.csum[tile] = total;
    if (holes) {
      block_scan(hole, &total);
      if (threadIdx.x == 0) sc.hsum[tile] = total;
    }
  }
}

// stage (c) over N slots: start_of and the hit table; (holes) the hole
// rank and the slot-of-rank table, else the locked step's newborn counts
// zeroed. Returns the step's total hits.
__device__ int stage_c(const Scratch& sc, int N, int G, int HB, bool holes) {
  const int T = n_tiles(N);
  const int total = block_sum(sc.sl.csum, T);
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    const bool in = i < N;
    const int cnt = in ? sc.sl.cnt[i] : 0;
    int tile_total;
    const int start = grid_rank(sc.sl.csum, tile, cnt, &tile_total);
    int hole = 0, h_rank = 0;
    if (holes) {
      hole = in && !(sc.sl.flags[i] & kKeep) ? 1 : 0;
      h_rank = grid_rank(sc.hsum, tile, hole, &tile_total);
    }
    if (in) {
      own_hits(sc.sl, i, cnt, start, total, G);
      if (!holes) {
        sc.nb_cnt[i] = 0;
      } else {
        sc.hrank[i] = h_rank;
        if (hole && h_rank < HB) sc.slot_of[h_rank] = i;
      }
    }
  }
  return total;
}

// One hole-allocated narrow step over N slots, cur -> nxt (port of
// _build_narrow_step(locked=False)); the grid is synchronised before it.
__device__ void narrow_step(const Params& p, const Scratch& sc, Carry cur,
                            Carry nxt, const int* row, int N, int G, int W,
                            int log_base, cg::grid_group& grid) {
  const int R = p.R, HB = G * p.x.B;
  const int T = n_tiles(N), TK = n_tiles(HB);
  stage_a_all(p, sc, cur, row, false, N);
  grid.sync();
  stage_b(p, sc, cur, N, W, true);
  grid.sync();
  const int total = stage_c(sc, N, G, HB, true);
  grid.sync();

  // (d) hits x outcomes: log records, newborn candidates
  for (int tile = blockIdx.x; tile < TK; tile += gridDim.x) {
    const int k = tile * kThreads + threadIdx.x;
    int c = 0;
    if (k < HB) {
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

  // (e) hole allocation: candidate c_rank takes the hole of rank c_rank
  const int n_holes = block_sum(sc.hsum, T);
  const int n_cand = block_sum(sc.ksum, TK);
  const int room = n_holes < HB ? n_holes : HB;
  const int n_place = n_cand < room ? n_cand : room;
  for (int tile = blockIdx.x; tile < TK; tile += gridDim.x) {
    const int k = tile * kThreads + threadIdx.x;
    const int c = k < HB ? sc.cand[k] : 0;
    int tile_total;
    const int c_rank = grid_rank(sc.ksum, tile, c, &tile_total);
    if (c) {
      if (c_rank < room) {
        const int d = sc.slot_of[c_rank];
        nxt.rid[d] = sc.crid[k];
        nxt.lo[d] = sc.elo[k];
        nxt.hi[d] = sc.ehi[k];
        nxt.pref[d] = log_base + k;
      } else {
        p.ovf[sc.crid[k]] = 1;                    // a dropped newborn
      }
    }
  }
  bool dump = blockIdx.x == 0 && n_cand - n_place < HB;
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    if (i >= N) continue;
    const int f = sc.sl.flags[i];
    const bool keep = f & kKeep;
    const int rid = cur.rid[i];
    if (keep || sc.hrank[i] >= n_place) {         // not a newborn's hole
      nxt.rid[i] = keep ? rid : -1;
      nxt.lo[i] = sc.klo[i];
      nxt.hi[i] = sc.khi[i];
      nxt.pref[i] = cur.pref[i];
    }
    if (f & (kSpillW | kSpilled)) p.ovf[clampi(rid, 0, R - 1)] = 1;
    else dump = true;
  }
  if (__syncthreads_or(dump) && threadIdx.x == 0) p.ovf[R] = 1;
}

// _lock_pool: src (n_src states) -> dst (R slots); three passes, the grid
// synchronised before it and before each pass
__device__ void lock_pool(const Params& p, const Scratch& sc, Carry src,
                          int n_src, Carry dst, cg::grid_group& grid) {
  const int R = p.R;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  for (int i = tid; i < R; i += nthreads) sc.nb_cnt[i] = 0;
  grid.sync();
  for (int j = tid; j < n_src; j += nthreads) {
    const int r = src.rid[j];
    if (r >= 0) atomicAdd(sc.nb_cnt + clampi(r, 0, R - 1), 1);
  }
  grid.sync();
  // slot i is written by its placed state or, if none, with the fill:
  // exactly one writer either way
  const int n_all = max(n_src, R);
  for (int i = tid; i < n_all; i += nthreads) {
    if (i < R) {
      const int c = sc.nb_cnt[i];
      if (c > 1) p.ovf[i] = 1;
      if (c != 1) {
        dst.rid[i] = -1;
        dst.lo[i] = 0;
        dst.hi[i] = 0;
        dst.pref[i] = 0;
      }
    }
    if (i < n_src) {
      const int r = src.rid[i];
      const int rc = clampi(r, 0, R - 1);
      if (r >= 0 && sc.nb_cnt[rc] == 1) {
        dst.rid[rc] = rc;
        dst.lo[rc] = src.lo[i];
        dst.hi[rc] = src.hi[i];
        dst.pref[rc] = src.pref[i];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
locked_tail_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  const Scratch sc = scratch_of(p);
  const int R = p.R, B = p.x.B, C = p.C;
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

  // ---- the hole-allocated steps (_resize_pool, then the steps) ----------
  if (p.Nn > 0) {
    grid.sync();
    resize(carry_at(p.carry, 0, C), n_cur, p.Nn, R, p.ovf);
    n_cur = p.Nn;
    for (int s = 0; s < p.n_narrow; ++s) {
      grid.sync();
      narrow_step(p, sc, carry_at(p.carry, buf, C),
                  carry_at(p.carry, buf ^ 1, C), row, p.Nn, p.Gn, p.Wn,
                  log_base, grid);
      buf ^= 1;
      row += R;
      log_base += p.Gn * B;
    }
  }

  // ---- the lock (_lock_pool) ----------------------------------------------
  if (p.lock) {
    grid.sync();
    lock_pool(p, sc, carry_at(p.carry, buf, C), n_cur,
              carry_at(p.carry, buf ^ 1, C), grid);
    buf ^= 1;
    n_cur = R;
  }
  if (p.n_locked == 0) return;
  grid.sync();

  // ---- stage (a) of the first slot-locked step --------------------------
  stage_a_all(p, sc, carry_at(p.carry, buf, C), row, true, R);

  const int G = p.G, T = n_tiles(R);
  for (int s = 0; s < p.n_locked; ++s) {
    const Carry cur = carry_at(p.carry, buf, C);
    const Carry nxt = carry_at(p.carry, buf ^ 1, C);
    grid.sync();
    stage_b(p, sc, cur, R, p.W, false);
    grid.sync();
    const int total = stage_c(sc, R, G, G * B, false);
    grid.sync();

    // ---- (d) hits x outcomes: loci, log records, newborns ---------------
    for (int k = tid; k < G * B; k += nthreads) {
      const Birth nb = hit_pair(p.x, sc.sl, cur.pref, k, G, total, log_base,
                                p.lp, p.le);
      if (nb.ok && atomicAdd(sc.nb_cnt + nb.s, 1) == 0) {
        sc.nb_lo[nb.s] = nb.lo;
        sc.nb_hi[nb.s] = nb.hi;
        sc.nb_pref[nb.s] = log_base + k;
      }
    }
    grid.sync();

    // ---- (e) placement, overflow; then (a) of the next step -------------
    const bool more = s + 1 < p.n_locked;
    const int* next_row = row + R;
    for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
      const int i = tile * kThreads + threadIdx.x;
      int wide = 0;
      if (i < R) {
        const int f = sc.sl.flags[i];
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
          rid = keep ? cur.rid[i] : -1;
          lo = sc.klo[i];
          hi = sc.khi[i];
          pref = cur.pref[i];
        }
        if (conflict) rid = -1;
        nxt.rid[i] = rid;
        nxt.lo[i] = lo;
        nxt.hi[i] = hi;
        nxt.pref[i] = pref;
        if (conflict || (f & (kSpillW | kSpilled))) p.ovf[i] = 1;
        if (more) wide = stage_a(p, sc, next_row, true, i, rid, lo, hi);
      }
      if (more) {
        int total_w;
        block_scan(wide, &total_w);
        if (threadIdx.x == 0) sc.wsum[tile] = total_w;
      }
    }
    buf ^= 1;
    row = next_row;
    log_base += G * B;
  }
}

// co-resident blocks of the kernel on each device, queried once
int g_max_blocks[kMaxDevices];

}  // namespace

extern "C" long long locked_tail_scratch(int C, int K, int g_max) {
  return scratch_ints(C, K, g_max);
}

// The grid the launch will use for C slots and K hit pairs: at most the
// blocks co-resident on the current device (queried once a device), no
// more than the work needs. Returns -(CUDA error) on failure.
extern "C" int locked_tail_grid(int C, int K) {
  return coop_grid(locked_tail_kernel, g_max_blocks,
                   max(n_tiles(C), n_tiles(K)));
}

extern "C" int locked_tail(
    const void* rid_in, const void* lo_in, const void* hi_in,
    const void* pref_in, const void* ovf_in, int n_in,
    const void* reads, int R, int n_narrow, int Nn, int Gn, int Wn, int lock,
    int n_locked, int G, int W,
    const void* narrow_tab, int n, const void* occ, const void* blocks,
    const void* sym_start, const void* sentinel_row,
    const void* mrl, int n_mrl, const void* out_lo, const void* out_hi,
    int L, int B, int log_base, void* lp, void* le,
    void* carry, int C, void* ovf, void* scratch, int grid, void* stream) {
  Params p;
  p.x.narrow_tab = static_cast<const int*>(narrow_tab);
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
  p.n_narrow = n_narrow;
  p.Nn = Nn;
  p.Gn = Gn;
  p.Wn = Wn;
  p.lock = lock;
  p.n_locked = n_locked;
  p.G = G;
  p.W = W;
  p.log_base = log_base;
  p.lp = static_cast<int*>(lp);
  p.le = static_cast<int*>(le);
  p.carry = static_cast<int*>(carry);
  p.C = C;
  p.ovf = static_cast<unsigned char*>(ovf);
  p.scratch = static_cast<int*>(scratch);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)locked_tail_kernel, dim3(grid), dim3(kThreads), args, 0,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
