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
// = 10 the tail is 8 hole-allocated and 130 slot-locked steps of a
// 144-step scan. Here the whole tail is one launch.
//
// The carry (read_id, lo, hi, pref) lives in ``carry`` (2, 4, C), C >=
// every pool size; the inputs are never written. ``ovf`` (R + 1,) gets the
// input flags (the last entry is the scan's dump slot) ORed with every
// flag the steps raise, and the dump slot wherever the twin's scatter
// routes an unflagged entry there.
//
// Start: the incoming pool (n_in states) is copied into buffer 0.
//
// Hole-allocated steps (n_narrow of them, pool Nn, budgets Gn and Wn),
// double-buffered: a step reads one buffer and writes the other.
// _resize_pool from n_in to Nn first (scan_common.cuh), then five stages
// a step, split by grid syncs:
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
// Their newborns land in any slot, so each of these steps needs its
// barriers.
//
// Lock (``lock`` != 0; _lock_pool): count each read's live states into a
// zeroed (R,) scratch; a read with one state gets it in its slot, a read
// with more is flagged; the other slots hold (-1, 0, 0, 0).
//
// Slot-locked steps (n_locked of them; pool slot i IS read i, R slots in
// T = R / 256 tiles), with no grid barrier inside or between them. A
// locked step is slot-local but for three couplings: the exclusive rank
// of the wide states (held against W), the exclusive sum of marker hits
// (held against G; it fixes each hit's log position and the spilled
// flag) and the empty hit records g in [min(total, G), G), which carry
// the pref of the last slot with hits (slot 0's when total = 0). A newborn
// lands in its owner's own slot, conflict and overflow are per slot, and
// a dead slot stays dead. So:
//   * Fixed ownership: block b owns tiles b, b + grid, ... at every step
//     and takes them in increasing order, step after step. Its first
//     kOwnTiles tiles keep their carry in shared memory for the whole
//     range (written out once at the end); the rest stay in place in the
//     output buffer, each slot read and written by its own thread, so the
//     range needs no double buffer.
//   * The two ranks by single-pass chained scans with decoupled
//     look-back (Merrill and Garland, NVIDIA 2016) over (n_locked, T)
//     descriptors, zeroed in the launch behind the grid sync before the
//     range. After stage (a) a tile publishes its wide count (an
//     aggregate; tile 0 its inclusive prefix); only a tile holding a
//     wide state waits for its exclusive prefix, by looking back with
//     its last warp, then publishes its inclusive prefix. Then it
//     publishes its hit payload (hits, last slot with hits, that slot's
//     pref; combined right-biased: (a + b).last = b.last if b has one,
//     else a.last, which is associative; tile 0's payload carries slot
//     0's pref when it has no hit); a tile with hits, and the last tile,
//     look back for its exclusive prefix the same way, with the block's
//     last warp. A wide count is one 64-bit word (state << 32 | count);
//     a hit payload is wider, so its fields are stored, then its state
//     word with release order (cuda::atomic_ref at device scope); a
//     reader loads the state word with acquire order, spinning with
//     __nanosleep while it is empty, then the fields.
//   * Why the waits cannot deadlock: a tile waits only on tiles before it
//     at the same step, each block takes its tiles in (step, tile) order,
//     and the cooperative launch makes every block co-resident; so the
//     least (step, tile) not yet done waits on finished tiles only.
//   * Each tile's hit pairs [start_t, min(start_t + cnt_t, G)) x B by its
//     own block: a pair finds its owner by a binary search over the
//     tile's prefix of cnt in shared memory, LF-extends its newborn,
//     writes its log record in place and counts the newborn into a
//     shared-memory counter of its owner's slot (no global atomics).
//     Which newborn a slot keeps does not matter: a count above 1 is a
//     conflict, and then the kept values are never read. A pair's owner,
//     locus and newborn need only the tile's own prefix (the owner's
//     marker rank offset is its own hit index), so the first 56 pairs
//     run their chain of dependent loads while the last warp looks back;
//     the tile's start then only cuts them at G and places their
//     records. A pair is worked by a team of 4 lanes, each counting one
//     code vector of the packed occ records (the count is most of a
//     pair's instructions, and a tile has few pairs). The last tile
//     writes the empty records [min(total, G), G) x B.
//   * Then stage (e) (conflict: two newborns, or one beside a kept
//     parent, clears the slot's read_id; a sole newborn with no kept
//     parent takes the slot; spilled | spill_w | conflict go to ovf) for
//     the tile's slots, and the tile is done for this step.
// As in the twin, a live state's cnt is >= 0 (its lo <= hi), which the
// owner search relies on.
//
// What bounds it on the card: latency, not bytes. A locked step moves ~290
// KB and does a few dozen integer ops a slot; the 130 steps are a chain,
// each needing at least one dependent narrow-table load after its carry (the
// latency floor: ~0.18 us a load warm in L2, on an H100). The design before
// this one split each step by four grid barriers (~16 us a step on an H100).
// Now a step is one tile's own chain: its base and narrow loads, its cnt
// scan, its pairs' chain (the outcome bounds, then two packed occ records
// and their count), placement; the look-back waits overlap the pairs' chain,
// and tiles of later steps run ahead of earlier tiles' waits. To shorten
// that chain: the descriptors' release and acquire in place of full fences;
// the pairs started before the look-back, each by a team of 4 lanes; an L2
// hint for the next step's base and narrow word at placement, and for a
// marker's outcome bounds at stage (a). Registers: 118 a thread, no spills,
// 25,712 bytes of static shared memory a block (nvcc -Xptxas -v, CUDA 12.8,
// sm_90a): two blocks an SM, more than the path's grid needs; so the locked
// range stays in the one launch with the hole-allocated range. The carry of
// a block's first 4 tiles stays in shared memory across the range (16 KB);
// with more tiles a block, the rest stay in place in global memory. Built
// with -DK3_STAMPS, the kernel also records the global timer at the stages
// of each step of three tiles (locked_tail_stamps).
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers and PyTorch's current stream; locked_tail returns the
// launch's CUDA error, 0 on success.

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace scan_dev;

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kOwnTiles = 4;       // tiles a block keeps in shared memory
constexpr int kDescInts = 8;       // a hit descriptor: state, agg, inc
// descriptor states
constexpr int kEmpty = 0, kAggregate = 1, kInclusive = 2;
constexpr int kMaxSpins = 1 << 26;   // waits for one descriptor

// Stage timestamps of the slot-locked steps, compiled in only with
// -DK3_STAMPS (a probe build, never the path's): the global timer at 8
// points of each step of tiles 0, T / 2 and T - 1, read back with
// locked_tail_stamps.
constexpr int kStampSteps = 256;
#ifdef K3_STAMPS
__device__ unsigned long long g_stamps[kStampSteps * 3 * 8];
__device__ __forceinline__ void stamp(int k, int step, int tile, int T) {
  const int sel = tile == 0 ? 0 : tile == T / 2 ? 1 : tile == T - 1 ? 2 : -1;
  if (sel < 0 || step >= kStampSteps) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamps[(step * 3 + sel) * 8 + k] = t;
}
#define STAMP(k, who) \
  if (threadIdx.x == (who)) stamp(k, step, tile, T)
#else
#define STAMP(k, who)
#endif

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
  int* scratch;               // scratch_ints(C, K, G_max, n_locked, R)
};

// the locked range's descriptors: (n_locked, T) 64-bit wide counts, then
// (n_locked, T, kDescInts) hit descriptors, at the front of the scratch
__host__ __device__ inline long long desc_ints(int n_locked, int R) {
  return (long long)n_locked * n_tiles(R) * (2 + kDescInts);
}

__host__ __device__ inline long long scratch_ints(int C, int K, int g_max,
                                                  int n_locked, int R) {
  return desc_ints(n_locked, R) + 10LL * C + 5LL * K + g_max
         + 3LL * n_tiles(C) + n_tiles(K) + 1;
}

struct Scratch {
  unsigned long long* wdesc;   // (n_locked, T) wide counts
  int* hdesc;                  // (n_locked, T, kDescInts) hit payloads
  Slots sl;       // flags, base, cnt, hit, start, table, csum, last
  int* t;         // narrow_tab word
  int* klo;       // kept_lo / kept_hi
  int* khi;
  int* lock_cnt;  // (R,) the lock's live states a read
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
  const long long n_desc = (long long)p.n_locked * n_tiles(p.R);
  s.wdesc = reinterpret_cast<unsigned long long*>(p.scratch);
  s.hdesc = p.scratch + 2 * n_desc;
  int* q = p.scratch + desc_ints(p.n_locked, p.R);
  int** per_slot[] = {&s.sl.flags, &s.sl.base, &s.sl.cnt, &s.sl.hit,
                      &s.sl.start, &s.t, &s.klo, &s.khi, &s.lock_cnt,
                      &s.hrank};
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

// ---- the hole-allocated steps -------------------------------------------

// stage (a) over N slots of carry ``cur``: the per-slot fields and each
// tile's wide count
__device__ void stage_a_all(const Params& p, const Scratch& sc, Carry cur,
                            const int* row, int N) {
  for (int tile = blockIdx.x; tile < n_tiles(N); tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    int wide = 0;
    if (i < N) {
      const int rid = cur.rid[i], lo = cur.lo[i], hi = cur.hi[i];
      const bool valid = rid >= 0;
      const int base = valid ? __ldg(row + clampi(rid, 0, p.R - 1)) : 0;
      const bool active = valid && base > 0;
      const bool single = lo == hi;
      wide = active && !single;
      sc.sl.flags[i] = (valid ? kValid : 0) | (active ? kActive : 0)
                       | (single ? kSingle : 0) | (wide ? kWide : 0);
      sc.sl.base[i] = base;
      sc.t[i] = __ldg(p.x.narrow_tab + clampi(lo, 0, p.x.n - 1));
    }
    int total;
    block_scan(wide, &total);
    if (threadIdx.x == 0) sc.wsum[tile] = total;
  }
}

// stage (b) over N slots: wide rank, LF of the covered wide states, keep,
// cnt; each tile's cnt sum and hole count
__device__ void stage_b(const Params& p, const Scratch& sc, Carry cur, int N,
                        int W) {
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
    block_scan(hole, &total);
    if (threadIdx.x == 0) sc.hsum[tile] = total;
  }
}

// stage (c) over N slots: start_of and the hit table, the hole rank and
// the slot-of-rank table. Returns the step's total hits.
__device__ int stage_c(const Scratch& sc, int N, int G, int HB) {
  const int T = n_tiles(N);
  const int total = block_sum(sc.sl.csum, T);
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int i = tile * kThreads + threadIdx.x;
    const bool in = i < N;
    const int cnt = in ? sc.sl.cnt[i] : 0;
    int tile_total;
    const int start = grid_rank(sc.sl.csum, tile, cnt, &tile_total);
    const int hole = in && !(sc.sl.flags[i] & kKeep) ? 1 : 0;
    const int h_rank = grid_rank(sc.hsum, tile, hole, &tile_total);
    if (in) {
      own_hits(sc.sl, i, cnt, start, total, G);
      sc.hrank[i] = h_rank;
      if (hole && h_rank < HB) sc.slot_of[h_rank] = i;
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
  stage_a_all(p, sc, cur, row, N);
  grid.sync();
  stage_b(p, sc, cur, N, W);
  grid.sync();
  const int total = stage_c(sc, N, G, HB);
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
  for (int i = tid; i < R; i += nthreads) sc.lock_cnt[i] = 0;
  grid.sync();
  for (int j = tid; j < n_src; j += nthreads) {
    const int r = src.rid[j];
    if (r >= 0) atomicAdd(sc.lock_cnt + clampi(r, 0, R - 1), 1);
  }
  grid.sync();
  // slot i is written by its placed state or, if none, with the fill:
  // exactly one writer either way
  const int n_all = max(n_src, R);
  for (int i = tid; i < n_all; i += nthreads) {
    if (i < R) {
      const int c = sc.lock_cnt[i];
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
      if (r >= 0 && sc.lock_cnt[rc] == 1) {
        dst.rid[rc] = rc;
        dst.lo[rc] = src.lo[i];
        dst.hi[rc] = src.hi[i];
        dst.pref[rc] = src.pref[i];
      }
    }
  }
}

// ---- the slot-locked steps: chained scans ---------------------------------

constexpr int kLead = (kWarps - 1) * 32;   // the look-back warp's first
                                           // thread
using DevInt = cuda::atomic_ref<int, cuda::thread_scope_device>;
using DevWord = cuda::atomic_ref<unsigned long long,
                                 cuda::thread_scope_device>;

// a hit payload: marker hits, the last slot with hits (-1: none) and its
// pref (in tile 0's payload without hits: slot 0's)
struct HitSum {
  int sum, last, pref;
};

// a then b (b the later tiles), right-biased in last/pref: associative
__device__ __forceinline__ HitSum hit_combine(HitSum a, HitSum b) {
  return b.last >= 0 ? HitSum{a.sum + b.sum, b.last, b.pref}
                     : HitSum{a.sum + b.sum, a.last, a.pref};
}

__device__ __forceinline__ int load(const int* a,
                                    cuda::std::memory_order order) {
  return DevInt(*const_cast<int*>(a)).load(order);
}

__device__ __forceinline__ void store(int* a, int v,
                                      cuda::std::memory_order order) {
  DevInt(*a).store(v, order);
}

// a wide count is one word: state << 32 | count
__device__ __forceinline__ void publish_wide(unsigned long long* d, int state,
                                             int count) {
  DevWord(*d).store(((unsigned long long)state << 32) | (unsigned)count,
                    cuda::std::memory_order_relaxed);
}

// the payload's fields, then the state word with release order (one
// thread)
__device__ __forceinline__ void publish_hits(int* d, int state, HitSum v) {
  int* f = d + (state == kInclusive ? 4 : 1);
  store(f, v.sum, cuda::std::memory_order_relaxed);
  store(f + 1, v.last, cuda::std::memory_order_relaxed);
  store(f + 2, v.pref, cuda::std::memory_order_relaxed);
  store(d, state, cuda::std::memory_order_release);
}

// one wait for a descriptor; a wait past ~seconds is a fault of the
// kernel, so it traps (a launch error) rather than hang the card
__device__ __forceinline__ void wait(int spins) {
  if (spins > kMaxSpins) __trap();
  __nanosleep(32);
}

// a hint to bring a's line into L2 (no wait, no fault)
__device__ __forceinline__ void prefetch_l2(const void* a) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// The wide states before tile t > 0 of one step (descriptors d), by
// decoupled look-back: lane l reads tile end - l of each window of 32,
// back to the nearest inclusive prefix. Called by one whole warp.
__device__ int wide_lookback(unsigned long long* d, int t) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int end = t - 1;; end -= 32) {
    const int j = end - lane;
    unsigned long long w = (unsigned long long)kInclusive << 32;
    if (j >= 0) {
      for (int spins = 0;
           ((w = DevWord(d[j]).load(cuda::std::memory_order_relaxed)) >> 32)
           == kEmpty; ++spins)
        wait(spins);
    }
    const unsigned inc = __ballot_sync(kAll, (w >> 32) == kInclusive);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    excl += warp_sum(lane <= stop ? (int)(unsigned)w : 0);
    if (inc) return excl;
  }
}

// The hit payload of the tiles before tile t > 0 of one step
// (descriptors d), by decoupled look-back: the state word with acquire
// order, then the fields. Called by one whole warp.
__device__ HitSum hit_lookback(const int* d, int t) {
  const int lane = threadIdx.x & 31;
  HitSum excl = {0, -1, 0};
  for (int end = t - 1;; end -= 32) {
    const int j = end - lane;
    int state = kInclusive;
    HitSum v = {0, -1, 0};
    if (j >= 0) {
      const int* e = d + (size_t)kDescInts * j;
      for (int spins = 0;
           (state = load(e, cuda::std::memory_order_acquire)) == kEmpty;
           ++spins)
        wait(spins);
      const int* f = e + (state == kInclusive ? 4 : 1);
      v = HitSum{load(f, cuda::std::memory_order_relaxed),
                 load(f + 1, cuda::std::memory_order_relaxed),
                 load(f + 2, cuda::std::memory_order_relaxed)};
    }
    const unsigned inc = __ballot_sync(kAll, state == kInclusive);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    const bool take = lane <= stop;
    const int sum = warp_sum(take ? v.sum : 0);
    // the nearest tile with a last slot, else the farthest taken one
    const unsigned has = __ballot_sync(kAll, take && v.last >= 0);
    const int src = has ? __ffs(has) - 1 : stop;
    const HitSum win = {sum, __shfl_sync(kAll, v.last, src),
                        __shfl_sync(kAll, v.pref, src)};
    excl = hit_combine(win, excl);
    if (inc) return excl;
  }
}

// the tile's fields that its hit pairs read, and its newborn counters
struct TileShared {
  int incl[kThreads];     // inclusive prefix of cnt in the tile
  int hit[kThreads];      // hitfield
  int base[kThreads];
  int single[kThreads];
  int pref[kThreads];
  int nb[kThreads];       // newborns of each slot
  int nb_lo[kThreads];    // one newborn's interval and pref
  int nb_hi[kThreads];
  int nb_pref[kThreads];
  int warp_last[kWarps];  // the last slot with hits in each warp
  int first[5];           // sym_start
  int w_excl;             // broadcasts of the look-backs
  HitSum h_excl, h_inc;
};

// one hit pair of a tile: its owner slot (in the tile), clamped locus,
// outcome, and newborn
struct Pair {
  int s, li, b;
  bool ok;
  int lo, hi;
};

constexpr int kTeam = 4;                   // lanes a hit pair
constexpr int kEarlyPairs = kLead / kTeam; // pairs started before the
                                           // look-back

// Occ row r by a pair's team of kTeam lanes, the same in each: lane v
// counts code vector v of r's packed record (packed_rank.cuh, rank_row's
// work spread over the team); a dense table's row is one load. Every lane
// of the warp calls it together.
__device__ __forceinline__ int4 team_row(const Index& x, int r, int v) {
  using namespace packed_rank_dev;
  if (x.blocks == nullptr) return __ldg(x.occ + clampi(r, 0, x.n));
  int off;
  const uint4* rec = record_of(x.blocks, r, x.n, &off);
  unsigned packed = off > 32 * v
      ? count_vec(__ldg(rec + kCodeVec0 + v), off - 32 * v) : 0u;
  packed += __shfl_xor_sync(kAll, packed, 1);
  packed += __shfl_xor_sync(kAll, packed, 2);
  return add_packed(__ldg(rec), packed);
}

// The tile's pair q (its hit q / B, outcome q % B) by its team (this
// lane is v of it), from the tile's shared fields alone: the owner by a
// binary search over the prefix of cnt, its jump locus (direct for a
// single state, marker_rank_locus for a wide one: hit - start_of is the
// owner's own hit index, so the tile's start is not needed), both
// outcome bounds together, and the newborn's LF by the owner's base.
// Every lane of the warp calls it together; ``live`` is false for a lane
// without a pair.
__device__ __forceinline__ Pair tile_pair(const Index& x, const TileShared& ts,
                                          int q, int v, bool live) {
  const int B = x.B;
  Pair r = {0, 0, 0, false, 0, 0};
  int j_lo = -1, j_hi1 = 0;
  if (live) {
    const int h = q / B;
    r.b = q - h * B;
#pragma unroll
    for (int half = kThreads / 2; half > 0; half >>= 1)   // incl[s] > h
      if (ts.incl[r.s + half - 1] <= h) r.s += half;
    const int hf = ts.hit[r.s];
    const int own = h - (r.s > 0 ? ts.incl[r.s - 1] : 0);
    const int loc = ts.single[r.s]
        ? hf : __ldg(x.mrl + clampi(add_wrap(hf, own), 0, x.n_mrl - 1));
    r.li = clampi(loc, 0, x.L - 1);
    if (loc >= 0) {
      j_lo = __ldg(x.out_lo + r.li * B + r.b);
      j_hi1 = add_wrap(__ldg(x.out_hi + r.li * B + r.b), 1);
    }
  }
  const bool rows = j_lo >= 0;
  const int4 rl = team_row(x, rows ? j_lo : 0, v);
  const int4 rh = team_row(x, rows ? j_hi1 : 0, v);
  if (rows) {
    const int jb = ts.base[r.s];
    const int f = ts.first[clampi(jb, 0, 4)];
    r.lo = f + chan(rl, jb);
    r.hi = f + chan(rh, jb) - 1;
    r.ok = r.lo <= r.hi;
  }
  return r;
}

// a tile's pair as log record k, written in place; its newborn counted
// into its owner's slot (one lane of the pair's team)
__device__ __forceinline__ void commit_pair(const Params& p, TileShared& ts,
                                            const Pair& r, int k) {
  p.lp[k] = ts.pref[r.s];
  p.le[k] = r.li * p.x.B + r.b;
  if (r.ok && atomicAdd(&ts.nb[r.s], 1) == 0) {
    ts.nb_lo[r.s] = r.lo;
    ts.nb_hi[r.s] = r.hi;
    ts.nb_pref[r.s] = k;
  }
}

// One slot-locked step (port of _build_narrow_step(locked=True)) of tile
// ``tile``, its carry at ``h`` (indexed by thread), with wide and hit
// descriptors wd, hd of the step.
__device__ void locked_tile(const Params& p, TileShared& ts, Carry h,
                            int step, int tile,
                            const int* row, int log_base,
                            unsigned long long* wd, int* hd, int sent) {
  const int R = p.R, B = p.x.B, G = p.G, T = n_tiles(R);
  const int x = threadIdx.x;
  const int i = tile * kThreads + x;
  const bool in = i < R;
  int rid = -1, lo = 0, hi = 0, pref = 0;
  if (in) {
    rid = h.rid[x];
    lo = h.lo[x];
    hi = h.hi[x];
    pref = h.pref[x];
  }
  STAMP(0, 0);
  // (a): the base and the narrow word load together
  const bool valid = rid >= 0;
  const bool single = lo == hi;
  const int base = valid ? __ldg(row + i) : 0;
  const int t = valid && single
      ? __ldg(p.x.narrow_tab + clampi(lo, 0, p.x.n - 1)) : 0;
  const bool active = valid && base > 0;
  const bool wide = active && !single;
  if (active && single && (t >> 24) == 5) {   // its pairs' outcome bounds
    const int li = clampi(t & 0xFFFFFF, 0, p.x.L - 1);
    prefetch_l2(p.x.out_lo + li * B);
    prefetch_l2(p.x.out_hi + li * B);
  }
  const int n_wide = __syncthreads_count(wide);
  STAMP(1, 0);
  if (x == 0)
    publish_wide(wd + tile, tile == 0 ? kInclusive : kAggregate, n_wide);

  // the wide rank, only where the tile holds a wide state
  int w_rank = 0;
  if (n_wide > 0) {
    if (x >= kLead) {
      const int e = tile == 0 ? 0 : wide_lookback(wd, tile);
      if (x == kLead) {
        if (tile > 0) publish_wide(wd + tile, kInclusive, e + n_wide);
        ts.w_excl = e;
      }
    }
    int total;
    const int r = block_scan(wide ? 1 : 0, &total);  // syncs before reading
    w_rank = ts.w_excl + r;
  }

  // (b)
  LF w = {0, 0, 0, 0};
  const bool cov_wide = wide && w_rank < p.W;
  if (cov_wide) w = lf_extend(p.x, lo, hi, base, sent);
  const bool spill_w = wide && !cov_wide;
  const int sym = t >> 24, val = t & 0xFFFFFF;
  const bool ok = single ? sym == base : w.nlo <= w.nhi;
  const bool ac = active && (single || cov_wide);
  const bool keep = (ac && ok) || (valid && !active);
  const int klo = ac ? (single ? val : w.nlo) : lo;
  const int khi = ac ? (single ? val : w.nhi) : hi;
  const int cnt = ac ? (single ? (sym == 5 ? 1 : 0) : w.mhi - w.mlo) : 0;
  const unsigned with_hits = __ballot_sync(kAll, cnt > 0);
  if ((x & 31) == 0)
    ts.warp_last[x >> 5] = with_hits ? x + 31 - __clz(with_hits) : -1;
  int tile_cnt;
  const int excl = block_scan(cnt, &tile_cnt);
  ts.incl[x] = excl + cnt;
  ts.hit[x] = single ? val : w.mlo;
  ts.base[x] = base;
  ts.single[x] = single;
  ts.pref[x] = pref;
  ts.nb[x] = 0;
  __syncthreads();
  STAMP(2, 0);

  // The hit payloads, and the exclusive prefix where the tile has hits or
  // closes the step, by the look-back warp; meanwhile the other warps
  // start the tile's first pairs, which need no prefix.
  const bool need = tile_cnt > 0 || tile == T - 1;
  const int n_pairs = tile_cnt * B;
  Pair early{};
  if (x >= kLead) {
    HitSum agg = {tile_cnt, -1, 0};
    if (x == kLead) {
      int last = -1;
      for (int q = 0; q < kWarps; ++q) last = max(last, ts.warp_last[q]);
      agg.last = last < 0 ? -1 : tile * kThreads + last;
      agg.pref = last >= 0 ? ts.pref[last] : (tile == 0 ? ts.pref[0] : 0);
      publish_hits(hd + (size_t)kDescInts * tile,
                   tile == 0 ? kInclusive : kAggregate, agg);
    }
    if (need) {
      const HitSum e = tile == 0 ? HitSum{0, -1, 0} : hit_lookback(hd, tile);
      if (x == kLead) {
        // tile 0's payload is its inclusive prefix (slot 0's pref kept)
        const HitSum inc = tile == 0 ? agg : hit_combine(e, agg);
        if (tile > 0) publish_hits(hd + (size_t)kDescInts * tile, kInclusive,
                                   inc);
        ts.h_excl = e;
        ts.h_inc = inc;
      }
    }
    STAMP(3, kLead);
  } else if (n_pairs > 0) {
    early = tile_pair(p.x, ts, x / kTeam, x % kTeam, x / kTeam < n_pairs);
  }
  STAMP(7, 0);
  bool spilled = false;
  if (need) {
    __syncthreads();
    STAMP(4, 0);
    const int start0 = ts.h_excl.sum;
    spilled = active && start0 + excl + cnt > G && cnt > 0;
    // (d) the tile's hit pairs within the budget, records from k0 on
    const int g_end = tile_cnt > G - start0 ? G : start0 + tile_cnt;
    const int n_ok = g_end > start0 ? (g_end - start0) * B : 0;
    const int k0 = log_base + start0 * B;
    const bool lead_lane = x % kTeam == 0;
    if (x < kLead && lead_lane && x / kTeam < n_ok)
      commit_pair(p, ts, early, k0 + x / kTeam);
    for (int q0 = kEarlyPairs; q0 < n_ok; q0 += kThreads / kTeam) {
      const int q = q0 + x / kTeam;
      const Pair r = tile_pair(p.x, ts, q, x % kTeam, q < n_ok);
      if (lead_lane && q < n_ok) commit_pair(p, ts, r, k0 + q);
    }
    // the empty hit records, by the tile that closes the step
    const int total = ts.h_inc.sum;
    if (tile == T - 1 && total < G) {
      for (int k = total * B + x; k < G * B; k += kThreads) {
        p.lp[log_base + k] = ts.h_inc.pref;
        p.le[log_base + k] = k % B;                // locus clamped to 0
      }
    }
  }
  __syncthreads();
  STAMP(5, 0);

  // (e) placement and flags; then the next step's two loads, hinted
  if (in) {
    const int c = ts.nb[x];
    const bool conflict = c > 1 || (c == 1 && keep);
    const bool born = c == 1 && !keep;
    const int nrid = born ? i : (keep && !conflict ? rid : -1);
    const int nlo = born ? ts.nb_lo[x] : klo;
    const int nhi = born ? ts.nb_hi[x] : khi;
    h.rid[x] = nrid;
    h.lo[x] = nlo;
    h.hi[x] = nhi;
    if (born) h.pref[x] = ts.nb_pref[x];
    if (conflict || spill_w || spilled) p.ovf[i] = 1;
    if (step + 1 < p.n_locked) {
      prefetch_l2(row + R + i);
      if (nrid >= 0 && nlo == nhi)
        prefetch_l2(p.x.narrow_tab + clampi(nlo, 0, p.x.n - 1));
    }
  }
  STAMP(6, 0);
}

// The slot-locked range: the carry in buffer ``buf`` on entry, in buffer
// buf ^ (n_locked & 1) on exit; descriptors zeroed.
__device__ void locked_range(const Params& p, const Scratch& sc, int buf,
                             const int* row, int log_base) {
  __shared__ int own[kOwnTiles][4][kThreads];
  __shared__ TileShared ts;
  const int R = p.R, T = n_tiles(R), x = threadIdx.x;
  const Carry in = carry_at(p.carry, buf, p.C);
  const Carry out = carry_at(p.carry, buf ^ (p.n_locked & 1), p.C);
  const int sent = __ldg(p.x.sentinel_row);
  if (x < 5) ts.first[x] = __ldg(p.x.sym_start + x);
  __syncthreads();
  // the carry of the block's j-th tile, indexed by thread
  auto home = [&](int j, int tile) {
    if (j < kOwnTiles) return Carry{own[j][0], own[j][1], own[j][2], own[j][3]};
    const int o = tile * kThreads;
    return Carry{out.rid + o, out.lo + o, out.hi + o, out.pref + o};
  };
  int j = 0;
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x, ++j) {
    const Carry h = home(j, tile);
    const int i = tile * kThreads + x;
    if (i < R) {
      h.rid[x] = in.rid[i];
      h.lo[x] = in.lo[i];
      h.hi[x] = in.hi[i];
      h.pref[x] = in.pref[i];
    }
  }
  for (int s = 0; s < p.n_locked; ++s) {
    unsigned long long* wd = sc.wdesc + (size_t)s * T;
    int* hd = sc.hdesc + (size_t)s * T * kDescInts;
    j = 0;
    for (int tile = blockIdx.x; tile < T; tile += gridDim.x, ++j) {
      locked_tile(p, ts, home(j, tile), s, tile, row, log_base, wd, hd,
                  sent);
    }
    row += R;
    log_base += p.G * p.x.B;
  }
  j = 0;
  for (int tile = blockIdx.x; tile < T && j < kOwnTiles;
       tile += gridDim.x, ++j) {
    const int i = tile * kThreads + x;
    if (i < R) {
      out.rid[i] = own[j][0][x];
      out.lo[i] = own[j][1][x];
      out.hi[i] = own[j][2][x];
      out.pref[i] = own[j][3][x];
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
  }
  if (p.n_locked == 0) return;

  // ---- the slot-locked steps: descriptors zeroed, then no grid sync -----
  {
    const long long n = desc_ints(p.n_locked, R);
    for (long long i = tid; i < n; i += nthreads) p.scratch[i] = 0;
  }
  grid.sync();
  locked_range(p, sc, buf, row, log_base);
}

// co-resident blocks of the kernel on each device, queried once
int g_max_blocks[kMaxDevices];

}  // namespace

extern "C" long long locked_tail_scratch(int C, int K, int g_max,
                                         int n_locked, int R) {
  return scratch_ints(C, K, g_max, n_locked, R);
}

// The grid the launch will use for C slots and K hit pairs: at most the
// blocks co-resident on the current device (queried once a device), no
// more than the work needs. Returns -(CUDA error) on failure.
extern "C" int locked_tail_grid(int C, int K) {
  return coop_grid(locked_tail_kernel, g_max_blocks,
                   max(n_tiles(C), n_tiles(K)));
}

#ifdef K3_STAMPS
// the stamps of the last launch, (kStampSteps, 3, 8) u64, into host
extern "C" int locked_tail_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
#endif

// The kernel's registers a thread, local (spill) bytes a thread and
// static shared bytes a block, into out[0:3]; returns the CUDA error.
extern "C" int locked_tail_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, locked_tail_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
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
