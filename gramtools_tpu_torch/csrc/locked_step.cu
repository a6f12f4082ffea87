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
// 144-step scan. Here the whole tail is one launch. Like the wide launch
// (wide_step.cu) it decodes packed reads where it loads a base (K6: the
// tail starts at a step offset that need not be a multiple of 4).
//
// The carry (read_id, lo, hi, pref) lives in ``carry`` (2, 4, C), C >=
// every pool size; the inputs are never written. ``ovf`` (R + 1,) gets the
// input flags (the last entry is the scan's dump slot) ORed with every
// flag the steps raise, and the dump slot wherever the twin's scatter
// routes an unflagged entry there.
//
// Start: the incoming pool (n_in states) is copied into buffer 0, the input
// flags into ``ovf``, and every step's scan descriptors are zeroed, behind
// one grid sync; behind a second, each block has its place (a block owns
// tiles place, place + grid, ... of every step: consecutive places on
// distinct SMs, scan_common.cuh).
//
// Hole-allocated steps (n_narrow of them, pool Nn, budgets Gn and Wn),
// double-buffered: a step reads one buffer and writes the other. A step
// keeps each slot's own row (read_id where kept, else -1; the kept or old
// interval; pref) but for the holes (!keep) of rank h < min(n_cand, Gn·B),
// which take the newborn candidate of rank h in (hit, outcome) order;
// spilled states, states past the wide budget and dropped newborns flag
// their read. Its couplings across the pool: the wide rank (held against
// W), the hit prefix (start_of, the spilled flag, the log positions, the
// empty hit records' owner), the hole rank and the candidate rank; and the
// hole of rank c may lie in any tile. Design: one grid sync a step, none
// inside it. A block owns the same tiles every step and takes them in
// order; a tile, on its own:
//   (a) reads its slots' carry: the own row of the last step, or, in a hole
//       of rank h below the last step's placed count, the newborn staged at
//       h; rid = clamp(read_id), base = reads[s, rid] where valid, active,
//       single = lo == hi, the narrow_tab word t of a single state (sym = t
//       >> 24, val = t & 0xFFFFFF), wide = active & !single;
//   (b) publishes its wide count and LF-extends its wide states (two occ
//       rows: the dense table, or the packed records with one nibble mask
//       a code word for the base and one for the DNA total) while its last
//       warp looks back for the exclusive wide rank (scan_common.cuh); a
//       wide state of rank >= W spills and its LF is dropped (a tile
//       without a wide state needs no rank: it looks back only after (d),
//       so that later tiles find its inclusive count); keep, kept
//       interval, cnt, hitfield;
//   (c) publishes its payload (holes, hits, last slot with hits and its
//       pref) and looks back for its exclusive prefix, while its other warps
//       work the first round of its hit pairs (a pair needs only the tile's
//       own prefix of hits; a tile whose first round needs every warp works
//       it before the look-back); writes every slot's own row into the
//       output buffer and each hole's rank; flags its spilled states;
//   (d) works its hit pairs [start, min(start + cnt, G)) x B (tile_pair):
//       each log record written in place, the newborn candidates compacted
//       in pair order; candidates in (hit, outcome) order are in the slot
//       order of their owners (an empty hit slot, g >= min(total, G), has
//       locus -1 and is never one), so the candidate rank is a chained scan
//       in tile order: the tile looks back for it and stages its candidates
//       at their rank;
//   (e) the tile that closes the step writes the empty hit records
//       [min(total, G), G) x B.
// A tile waits only on tiles before it at the same step; as in the locked
// range below, that cannot deadlock. Then one grid sync, after which
// every total is the closing tile's inclusive prefix. A newborn overwrites
// its hole's own row when the next step reads it (the twin's scatter over
// the own rows gives the same); off each tile's chain, a grid-stride loop
// flags the reads of the last step's dropped newborns (rank >= min(holes,
// Gn·B)). _resize_pool to Nn is folded into the first step: slots past
// n_in read as empty, and a grid-stride loop flags the cut slots' reads.
// After the last step its newborns are written into their holes. So the
// range takes 2 + n_narrow grid syncs from the launch's start, 10 for the
// path's 8 steps (the design before this one: 5 a step and 2 for the
// resize, 41).
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
//   * Fixed ownership: a block owns tiles place, place + grid, ... at
//     every step and takes them in increasing order, step after step. Its
//     first kOwnTiles tiles keep their carry in shared memory for the whole
//     range (written out once at the end); the rest stay in place in the
//     output buffer, each slot read and written by its own thread, so the
//     range needs no double buffer.
//   * The two ranks by the chained scans of scan_common.cuh over (n_locked,
//     T) descriptors, zeroed at the launch's start: after stage (a) a tile
//     publishes its wide count (an aggregate; tile 0 its inclusive
//     prefix); only a tile holding a wide state waits for its exclusive
//     prefix, by looking back with its last warp, then publishes its
//     inclusive prefix. Then it publishes its hit payload (hits, last slot
//     with hits, that slot's pref; tile 0's payload carries slot 0's pref
//     when it has no hit); a tile with hits, and the last tile, look back
//     for its exclusive prefix the same way, with the block's last warp.
//   * Why the waits cannot deadlock: a tile waits only on tiles before it
//     at the same step, each block takes its tiles in (step, tile) order,
//     and the cooperative launch makes every block co-resident; so the
//     least (step, tile) not yet done waits on finished tiles only.
//   * Each tile's hit pairs [start_t, min(start_t + cnt_t, G)) x B by its
//     own block (tile_pair), each newborn counted into a shared-memory
//     counter of its owner's slot (no global atomics). Which newborn a
//     slot keeps does not matter: a count above 1 is a conflict, and then
//     the kept values are never read. The first 56 pairs run their chain
//     of dependent loads while the last warp looks back, each by a team of
//     4 lanes; the tile's start then only cuts them at G and places their
//     records. The last tile writes the empty records [min(total, G), G) x
//     B.
//   * Then stage (e) (conflict: two newborns, or one beside a kept
//     parent, clears the slot's read_id; a sole newborn with no kept
//     parent takes the slot; spilled | spill_w | conflict go to ovf) for
//     the tile's slots, and the tile is done for this step.
// As in the twin, a live state's cnt is >= 0 (its lo <= hi), which the
// owner search relies on, in both ranges.
//
// What bounds it on the card: latency, not bytes. A hole-allocated step is
// one tile's chain a block (its carry, base and narrow loads, the wide
// states' two occ rows, three look-backs' L2 round trips, its pairs'
// chain, the stage copy) and the grid sync. A locked step moves ~290 KB and
// does a few dozen integer ops a slot; the 130 steps are a chain, each
// needing at least one dependent narrow-table load after its carry (the
// latency floor: ~0.18 us a load warm in L2, on an H100). A locked step is
// one tile's own chain: its base and narrow loads, its cnt scan, its pairs'
// chain (the outcome bounds, then two packed occ records and their count),
// placement; the look-back waits overlap the pairs' chain, and tiles of
// later steps run ahead of earlier tiles' waits. To shorten that chain:
// descriptors read in one round trip with no fences; the pairs
// started before the look-back, each by a team of 4 lanes; an L2 hint for
// the next step's base and narrow word at placement, and for a marker's
// outcome bounds at stage (a). The carry of a block's first 4 tiles stays
// in shared memory across the locked range (16 KB); with more tiles a
// block, the rest stay in place in global memory. Registers: 121 a
// thread, no spills, 31,960 bytes of static shared memory a block (nvcc
// -Xptxas -v, CUDA 12.8, sm_90a): two blocks an SM. Built with -DK3_STAMPS,
// the kernel also records the global timer at the stages of each step of
// three tiles, of both ranges (locked_tail_stamps), and counts its grid
// syncs (locked_tail_syncs).
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

constexpr int kOwnTiles = 4;       // tiles a block keeps in shared memory
constexpr int kNoHole = 0x7FFFFFFF;   // a kept slot's hole rank

// Stage timestamps, compiled in only with -DK3_STAMPS (a probe build,
// never the path's): the global timer at the stages of each step of tiles
// 0, T / 2 and T - 1 (scan_common.cuh), the locked steps' in g_stamps and
// the hole-allocated steps' in g_nstamps, read back with
// locked_tail_stamps.
#ifdef K3_STAMPS
__device__ unsigned long long g_stamps[kStampSteps * 3 * kStampPts];
__device__ unsigned long long g_nstamps[kStampSteps * 3 * kStampPts];
#define STAMP(k, who) \
  if (threadIdx.x == (who)) stamp_at(g_stamps, k, step, tile, T)
#define NSTAMP(k, who) \
  if (threadIdx.x == (who)) stamp_at(g_nstamps, k, step, tile, T)
__device__ unsigned long long g_npub[kStampSteps * kPubTiles * kPubPts];
#define NPUB(k) \
  if (threadIdx.x == kLead) pub_at(g_npub, k, step, tile)
#else
#define STAMP(k, who)
#define NSTAMP(k, who)
#define NPUB(k)
#endif

struct Params {
  Index x;
  const int* rid_in;          // (n_in,) carry in, never written
  const int* lo_in;
  const int* hi_in;
  const int* pref_in;
  const unsigned char* ovf_in;   // (R + 1,)
  int n_in;
  Reads rd;                   // (n_narrow + n_locked, R) bases, int32 or
  int R;                      // packed
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
  int* scratch;               // scratch_ints(C, Kn, n_narrow, Nn, n_locked, R)
};

// count words: the locked steps' wide counts (n_locked, T_R), then each
// hole-allocated step's wide and candidate counts (n_narrow, 2, T_N)
__host__ __device__ inline long long n_words(int n_narrow, int Nn,
                                             int n_locked, int R) {
  return (long long)n_locked * n_tiles(R) + 2LL * n_narrow * n_tiles(Nn);
}

// payload descriptors: the locked steps' (n_locked, T_R), then the
// hole-allocated steps' (n_narrow, T_N)
__host__ __device__ inline long long n_descs(int n_narrow, int Nn,
                                             int n_locked, int R) {
  return (long long)n_locked * n_tiles(R) + (long long)n_narrow * n_tiles(Nn);
}

// the narrow stage (two buffers) and compacted candidates (Kn int4 each),
// the count words and payload descriptors, the blocks' slot counters
// (sm_slot), the lock's (C,) counts and the (C,) hole ranks
__host__ __device__ inline long long scratch_ints(int C, int Kn, int n_narrow,
                                                  int Nn, int n_locked,
                                                  int R) {
  return 12LL * Kn + kWordInts * n_words(n_narrow, Nn, n_locked, R)
         + 2LL * kDescWords * n_descs(n_narrow, Nn, n_locked, R) + kMaxSm
         + 2LL * C;
}

struct Scratch {
  int4* stages;               // (2, Kn) newborns by candidate rank
  int4* cand;                 // (Kn,) each tile's candidates, compacted
  unsigned long long* lwords; // (n_locked, T_R) wide counts
  unsigned long long* nwords; // (n_narrow, 2, T_N) wide, candidate counts
  unsigned long long* ldescs; // (n_locked, T_R, kDescWords) hit payloads
  unsigned long long* ndescs; // (n_narrow, T_N, kDescWords) hole-hit ones
  int* sm_cnt;                // (kMaxSm,) the blocks' slot counters
  long long n_zero;           // ints from lwords on, zeroed at the start
  int* lock_cnt;              // (C,) the lock's live states a read
  int* hrank;                 // (C,) each slot's hole rank (kNoHole: kept)
};

__device__ Scratch scratch_of(const Params& p) {
  Scratch s;
  const int Kn = p.Nn > 0 ? p.Gn * p.x.B : 0;
  const long long nw = n_words(p.n_narrow, p.Nn, p.n_locked, p.R);
  const long long nd = n_descs(p.n_narrow, p.Nn, p.n_locked, p.R);
  s.stages = reinterpret_cast<int4*>(p.scratch);
  s.cand = s.stages + 2 * (size_t)Kn;
  s.lwords = reinterpret_cast<unsigned long long*>(s.cand + Kn);
  s.nwords = s.lwords + (long long)p.n_locked * n_tiles(p.R);
  s.ldescs = s.lwords + nw;
  s.ndescs = s.ldescs + (long long)p.n_locked * n_tiles(p.R) * kDescWords;
  s.sm_cnt = reinterpret_cast<int*>(s.ldescs + kDescWords * nd);
  s.n_zero = kWordInts * nw + 2LL * kDescWords * nd + kMaxSm;
  s.lock_cnt = s.sm_cnt + kMaxSm;
  s.hrank = s.lock_cnt + p.C;
  return s;
}

// ---- the hole-allocated steps -------------------------------------------

// the block's shared fields of the hole-allocated tile it works on
struct NarrowShared {
  PairTile pt;
  int rid[kThreads];        // each slot's read, clamped
  int warp_last[kWarps];    // the last slot with hits in each warp
  Payload excl, inc;        // the look-backs' broadcasts
  int w_excl, c_excl;
};

// One tile of one hole-allocated narrow step (port of
// _build_narrow_step(locked=False)) over N slots: slot i reads cur's row i
// (i < lim; else an empty slot) or, in a hole of the last step's rank h <
// n_place, the newborn stage_in[h]; every slot's own row goes to nxt and its
// hole rank to hrank; the tile's candidates are staged at their rank in
// stage. wd, cd, pd: the step's wide and candidate count words and payload
// descriptors.
template <class L>
__device__ void narrow_tile(const Params& p, NarrowShared& ts, Carry cur,
                            int lim, int n_place, const int4* stage_in,
                            int* hrank, Carry nxt, int4* stage, int4* cand,
                            int N, int G, int W,
                            int log_base, int tile, int T,
                            unsigned long long* wd, unsigned long long* cd,
                            unsigned long long* pd, int sent, int step) {
  const int R = p.R, B = p.x.B, x = threadIdx.x;
  const int i = tile * kThreads + x;
  const bool in = i < N;
  NSTAMP(0, 0);
  // (a) the carry, base, narrow word
  int4 c = fill_row();
  if (in) {
    if (i < lim) c = carry_row(cur, i);
    if (n_place > 0) {
      const int h = hrank[i];
      if (h < n_place) c = stage_in[h];          // the newborn in its hole
    }
  }
  const int rid = c.x, lo = c.y, hi = c.z, pref = c.w;
  const bool valid = rid >= 0;
  const int rc = clampi(rid, 0, R - 1);
  const bool single = lo == hi;
  const int base = valid ? read_base<L>(p.rd, step, rc) : 0;
  const int t = valid && single ? __ldg(narrow_at<L>(p.x, lo)) : 0;
  const bool active = valid && base > 0;
  const bool wide = active && !single;
  NSTAMP(9, 0);
  // (b) the wide count published, the wide states' LF while the last warp
  // looks back for the wide rank (the rank decides which LF is kept); a
  // tile without a wide state needs no rank, and looks back only once its
  // candidates are published (later tiles' look-backs stay short)
  const int n_wide = __syncthreads_count(wide);
  if (x == kLead)
    publish_count(wd + tile, tile == 0 ? kInclusive : kAggregate, n_wide);
  LF w = {0, 0, 0, 0};
  if (wide) w = lf_extend<L>(p.x, lo, hi, base, sent);
  NSTAMP(1, 0);
  int w_rank = 0;
  if (n_wide > 0) {
    if (x >= kLead && tile > 0) {
      const int e = count_lookback(wd, tile);
      if (x == kLead) {
        publish_count(wd + tile, kInclusive, e + n_wide);
        ts.w_excl = e;
      }
    } else if (x == kLead) {
      ts.w_excl = 0;
    }
    int n_w;
    w_rank = block_scan(wide ? 1 : 0, &n_w) + ts.w_excl;
  }
  const bool cov = wide && w_rank < W;
  const bool spill_w = wide && !cov;
  if (!cov) w = LF{0, 0, 0, 0};                  // wball: 0 unless covered
  const Merged m = narrow_merge(valid, active, single, cov, base, t, w, lo,
                                hi);
  const bool keep = m.keep;
  const int klo = m.klo, khi = m.khi, cnt = m.cnt;
  const bool hole = in && !keep;
  const unsigned with_hits = __ballot_sync(kAll, cnt > 0);
  if ((x & 31) == 0)
    ts.warp_last[x >> 5] = with_hits ? x + 31 - __clz(with_hits) : -1;
  int n_holes, tile_cnt;
  const int hole_rank = block_scan(hole ? 1 : 0, &n_holes);
  const int excl = block_scan(cnt, &tile_cnt);
  ts.pt.incl[x] = excl + cnt;
  ts.pt.hit[x] = m.hit;
  ts.pt.base[x] = base;
  ts.pt.single[x] = single;
  ts.pt.pref[x] = pref;
  ts.rid[x] = rc;
  __syncthreads();
  NSTAMP(2, 0);

  // (c) the payload's chained scan by the last warp while the other warps
  // work the first round of pairs; a tile whose first round needs the last
  // warp too works it whole first
  const int n_pairs = tile_cnt * B;
  const bool heavy = n_pairs > kLead / pair_team(n_pairs);
  Pair early{};
  if (heavy) early = early_pair<L>(p.x, ts.pt, n_pairs);
  if (x >= kLead) {
    int last = -1;
    for (int k = 0; k < kWarps; ++k) last = max(last, ts.warp_last[k]);
    const Payload agg = {n_holes, tile_cnt,
                         last < 0 ? -1 : tile * kThreads + last,
                         last >= 0 ? ts.pt.pref[last]
                                   : (tile == 0 ? ts.pt.pref[0] : 0)};
    Payload inc;
    NPUB(0);
    const Payload e = payload_scan(pd, tile, agg, true, &inc);
    if (x == kLead) {
      ts.excl = e;
      ts.inc = inc;
    }
    NSTAMP(3, kLead);
  } else if (n_pairs > 0 && !heavy) {
    early = early_pair<L>(p.x, ts.pt, n_pairs);
  }
  __syncthreads();
  NSTAMP(4, 0);
  const Payload e = ts.excl;
  if (in) {                                       // the own row
    nxt.rid[i] = keep ? rid : -1;
    nxt.lo[i] = klo;
    nxt.hi[i] = khi;
    nxt.pref[i] = pref;
    hrank[i] = hole ? e.n + hole_rank : kNoHole;
  }
  const bool spilled = active && e.sum + excl + cnt > G && cnt > 0;
  const bool flagged = spilled || spill_w;
  if (flagged) p.ovf[rc] = 1;
  // the twin's scatter routes an unflagged slot's flag to the dump slot
  if (__syncthreads_or(in && !flagged) && x == 0) p.ovf[R] = 1;

  // (d) the pairs within the budget, then the candidates' rank
  const int g_end = tile_cnt > G - e.sum ? G : e.sum + tile_cnt;
  const int n_ok = g_end > e.sum ? (g_end - e.sum) * B : 0;
  const int k0 = n_ok > 0 ? e.sum * B : 0;
  const int n_c = staged_pairs<L>(p.x, ts.pt, ts.rid, n_pairs, n_ok,
                               log_base + k0, early, heavy, p.lp, p.le,
                               cand + k0);
  NSTAMP(5, 0);
  if (x >= kLead) {
    NPUB(1);
    const int ce = count_scan(cd, tile, n_c);
    if (x == kLead) ts.c_excl = ce;
    if (n_wide == 0 && tile > 0) {        // the deferred wide look-back
      const int we = count_lookback(wd, tile);
      if (x == kLead) publish_count(wd + tile, kInclusive, we);
    }
  }
  __syncthreads();
  NSTAMP(6, 0);
  const int ce = ts.c_excl;
  for (int j = x; j < n_c; j += kThreads) stage[ce + j] = cand[k0 + j];
  // (e) the empty hit records, by the tile that closes the step
  if (tile == T - 1 && ts.inc.sum < G) {
    const Payload inc = ts.inc;
    for (int k = inc.sum * B + x; k < G * B; k += kThreads) {
      p.lp[log_base + k] = inc.pref;
      p.le[log_base + k] = k % B;                 // locus clamped to 0
    }
  }
  NSTAMP(7, 0);
  __syncthreads();                 // ts is the next tile's
}

// The hole-allocated range (_resize_pool from n_in to Nn, then the
// steps), from buffer 0 to buffer n_narrow & 1; the grid is synchronised
// before it.
template <class L>
__device__ void narrow_range(const Params& p, const Scratch& sc,
                             NarrowShared& ts, int log_base, int sent,
                             int place, cg::grid_group& grid) {
  const int R = p.R, N = p.Nn, G = p.Gn, HB = G * p.x.B, T = n_tiles(N);
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  // the resize's cut slots flag their read (an empty one the dump slot)
  const Carry in0 = carry_at(p.carry, 0, p.C);
  for (int i = N + tid; i < p.n_in; i += nthreads) {
    const int r = in0.rid[i];
    if (r < 0) p.ovf[R] = 1;
    else if (r <= R) p.ovf[r] = 1;
  }
  int lim = min(p.n_in, N), n_place = 0, room = 0, n_cand = 0;
  const int4* stage_in = nullptr;
  // the last step's dropped newborns flag their read; its unflagged hit
  // pairs set the dump slot
  auto last_step_flags = [&]() {
    for (int c = room + tid; c < n_cand; c += nthreads)
      p.ovf[stage_in[c].x] = 1;
    if (tid == 0 && HB > max(n_cand - room, 0)) p.ovf[R] = 1;
  };
  for (int step = 0; step < p.n_narrow; ++step) {
    if (step > 0) last_step_flags();
    int4* stage = sc.stages + (size_t)(step & 1) * HB;
    unsigned long long* wd = sc.nwords + (size_t)step * 2 * T;
    unsigned long long* pd = sc.ndescs + (size_t)step * T * kDescWords;
    for (int tile = place; tile < T; tile += gridDim.x)
      narrow_tile<L>(p, ts, carry_at(p.carry, step & 1, p.C), lim,
                     n_place, stage_in, sc.hrank,
                     carry_at(p.carry, (step + 1) & 1, p.C), stage, sc.cand,
                     N, G, p.Wn, log_base, tile, T, wd, wd + T, pd, sent,
                     step);
    grid_sync(grid, 0);
#ifdef K3_STAMPS
    for (int tile = place; tile < T; tile += gridDim.x) NSTAMP(8, 0);
#endif
    // the step's totals, from the closing tile's inclusive prefixes
    const int n_holes = inclusive_payload(pd + (size_t)(T - 1) * kDescWords).n;
    n_cand = (int)(unsigned)wd[2 * T - 1];
    room = min(n_holes, HB);
    n_place = min(n_cand, room);
    stage_in = stage;
    lim = N;
    log_base += HB;
  }
  if (p.n_narrow > 0) last_step_flags();
  // the last step's newborns into their holes
  const Carry out = carry_at(p.carry, p.n_narrow & 1, p.C);
  if (n_place > 0)
    for (int i = tid; i < N; i += nthreads) {
      const int h = sc.hrank[i];
      if (h < n_place) put_row(out, i, stage_in[h]);
    }
}

// _lock_pool: src (n_src states) -> dst (R slots); three passes, the grid
// synchronised before it and before each pass
__device__ void lock_pool(const Params& p, const Scratch& sc, Carry src,
                          int n_src, Carry dst, cg::grid_group& grid) {
  const int R = p.R;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  for (int i = tid; i < R; i += nthreads) sc.lock_cnt[i] = 0;
  grid_sync(grid, 1);
  for (int j = tid; j < n_src; j += nthreads) {
    const int r = src.rid[j];
    if (r >= 0) atomicAdd(sc.lock_cnt + clampi(r, 0, R - 1), 1);
  }
  grid_sync(grid, 1);
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

// ---- the slot-locked steps --------------------------------------------

// the tile's fields that its hit pairs read, and its newborn counters
struct TileShared {
  PairTile pt;
  int nb[kThreads];       // newborns of each slot
  int nb_lo[kThreads];    // one newborn's interval and pref
  int nb_hi[kThreads];
  int nb_pref[kThreads];
  int warp_last[kWarps];  // the last slot with hits in each warp
  int w_excl;             // broadcasts of the look-backs
  Payload h_excl, h_inc;
};

constexpr int kEarlyPairs = kLead / kTeam; // pairs started before the
                                           // look-back

// a tile's pair as log record k, written in place; its newborn counted
// into its owner's slot (one lane of the pair's team)
__device__ __forceinline__ void commit_pair(const Params& p, TileShared& ts,
                                            const Pair& r, int k) {
  p.lp[k] = ts.pt.pref[r.s];
  p.le[k] = r.li * p.x.B + r.b;
  if (r.ok && atomicAdd(&ts.nb[r.s], 1) == 0) {
    ts.nb_lo[r.s] = r.lo;
    ts.nb_hi[r.s] = r.hi;
    ts.nb_pref[r.s] = k;
  }
}

// One slot-locked step (port of _build_narrow_step(locked=True)) of tile
// ``tile``, its carry at ``h`` (indexed by thread), with wide and hit
// descriptors wd, hd of the step; its bases are the launch's step ``rs``.
template <class L>
__device__ void locked_tile(const Params& p, TileShared& ts, Carry h,
                            int step, int tile, int rs, int log_base,
                            unsigned long long* wd, unsigned long long* hd,
                            int sent) {
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
  const int base = valid ? read_base<L>(p.rd, rs, i) : 0;
  const int t = valid && single ? __ldg(narrow_at<L>(p.x, lo)) : 0;
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
    publish_count(wd + tile, tile == 0 ? kInclusive : kAggregate, n_wide);

  // the wide rank, only where the tile holds a wide state
  int w_rank = 0;
  if (n_wide > 0) {
    if (x >= kLead) {
      const int e = tile == 0 ? 0 : count_lookback(wd, tile);
      if (x == kLead) {
        if (tile > 0) publish_count(wd + tile, kInclusive, e + n_wide);
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
  if (cov_wide) w = lf_extend<L>(p.x, lo, hi, base, sent);
  const bool spill_w = wide && !cov_wide;
  const Merged m = narrow_merge(valid, active, single, cov_wide, base, t, w,
                                lo, hi);
  const bool keep = m.keep;
  const int klo = m.klo, khi = m.khi, cnt = m.cnt;
  const unsigned with_hits = __ballot_sync(kAll, cnt > 0);
  if ((x & 31) == 0)
    ts.warp_last[x >> 5] = with_hits ? x + 31 - __clz(with_hits) : -1;
  int tile_cnt;
  const int excl = block_scan(cnt, &tile_cnt);
  ts.pt.incl[x] = excl + cnt;
  ts.pt.hit[x] = m.hit;
  ts.pt.base[x] = base;
  ts.pt.single[x] = single;
  ts.pt.pref[x] = pref;
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
    int last = -1;
    for (int q = 0; q < kWarps; ++q) last = max(last, ts.warp_last[q]);
    const Payload agg = {0, tile_cnt,
                         last < 0 ? -1 : tile * kThreads + last,
                         last >= 0 ? ts.pt.pref[last]
                                   : (tile == 0 ? ts.pt.pref[0] : 0)};
    Payload inc;
    const Payload e = payload_scan(hd, tile, agg, need, &inc);
    if (need && x == kLead) {
      ts.h_excl = e;
      ts.h_inc = inc;
    }
    STAMP(3, kLead);
  } else if (n_pairs > 0) {
    early = tile_pair<L>(p.x, ts.pt, x / kTeam, x % kTeam, kTeam,
                      x / kTeam < n_pairs);
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
      const Pair r = tile_pair<L>(p.x, ts.pt, q, x % kTeam, kTeam, q < n_ok);
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
      prefetch_l2(read_addr<L>(p.rd, rs + 1, i));
      if (nrid >= 0 && nlo == nhi) prefetch_l2(narrow_at<L>(p.x, nlo));
    }
  }
  STAMP(6, 0);
}

// The slot-locked range: the carry in buffer ``buf`` on entry, in buffer
// buf ^ (n_locked & 1) on exit; its descriptors zeroed at the launch's
// start.
template <class L>
__device__ void locked_range(const Params& p, const Scratch& sc, int buf,
                             int rs, int log_base, int place) {
  __shared__ int own[kOwnTiles][4][kThreads];
  __shared__ TileShared ts;
  const int R = p.R, T = n_tiles(R), x = threadIdx.x;
  const Carry in = carry_at(p.carry, buf, p.C);
  const Carry out = carry_at(p.carry, buf ^ (p.n_locked & 1), p.C);
  const int sent = __ldg(p.x.sentinel_row);
  if (x < 5) ts.pt.first[x] = __ldg(p.x.sym_start + x);
  __syncthreads();
  // the carry of the block's j-th tile, indexed by thread
  auto home = [&](int j, int tile) {
    if (j < kOwnTiles) return Carry{own[j][0], own[j][1], own[j][2], own[j][3]};
    const int o = tile * kThreads;
    return Carry{out.rid + o, out.lo + o, out.hi + o, out.pref + o};
  };
  int j = 0;
  for (int tile = place; tile < T; tile += gridDim.x, ++j) {
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
    unsigned long long* wd = sc.lwords + (size_t)s * T;
    unsigned long long* hd = sc.ldescs + (size_t)s * T * kDescWords;
    j = 0;
    for (int tile = place; tile < T; tile += gridDim.x, ++j) {
      locked_tile<L>(p, ts, home(j, tile), s, tile, rs + s, log_base, wd, hd,
                  sent);
    }
    log_base += p.G * p.x.B;
  }
  j = 0;
  for (int tile = place; tile < T && j < kOwnTiles;
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

template <class L>
__global__ void __launch_bounds__(kThreads)
locked_tail_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ NarrowShared ns;
  const Scratch sc = scratch_of(p);
  const int R = p.R, B = p.x.B, C = p.C;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  zero_syncs();

  // ---- the incoming pool and flags copied in, descriptors zeroed --------
  {
    const Carry b = carry_at(p.carry, 0, C);
    for (int i = tid; i < p.n_in; i += nthreads) {
      b.rid[i] = __ldg(p.rid_in + i);
      b.lo[i] = __ldg(p.lo_in + i);
      b.hi[i] = __ldg(p.hi_in + i);
      b.pref[i] = __ldg(p.pref_in + i);
    }
    for (int i = tid; i <= R; i += nthreads) p.ovf[i] = p.ovf_in[i];
    int* zero = reinterpret_cast<int*>(sc.lwords);
    for (long long i = tid; i < sc.n_zero; i += nthreads) zero[i] = 0;
  }
  if (threadIdx.x < 5) ns.pt.first[threadIdx.x] = __ldg(p.x.sym_start +
                                                        threadIdx.x);
#ifdef K3_STAMPS
  for (int i = tid; i < kStampSteps * kPubTiles * kPubPts; i += nthreads)
    g_npub[i] = 0;
#endif
  grid_sync(grid, 0);
  const int slot = sm_slot(sc.sm_cnt);
  grid_sync(grid, 0);
  const int place = sm_place(sc.sm_cnt, slot);
  int buf = 0, n_cur = p.n_in, log_base = p.log_base, rs = 0;

  // ---- the hole-allocated steps (_resize_pool folded into the first) ----
  if (p.Nn > 0) {
    if (p.n_narrow > 0) {
      narrow_range<L>(p, sc, ns, log_base, __ldg(p.x.sentinel_row), place, grid);
      buf = p.n_narrow & 1;
      rs = p.n_narrow;
      log_base += p.n_narrow * p.Gn * B;
    } else {
      resize(carry_at(p.carry, 0, C), n_cur, p.Nn, R, p.ovf);
    }
    n_cur = p.Nn;
  }

  // ---- the lock (_lock_pool) ----------------------------------------------
  if (p.lock) {
    grid_sync(grid, 1);
    lock_pool(p, sc, carry_at(p.carry, buf, C), n_cur,
              carry_at(p.carry, buf ^ 1, C), grid);
    buf ^= 1;
  }
  if (p.n_locked == 0) return;

  // ---- the slot-locked steps: no grid sync ---------------------------------
  grid_sync(grid, 1);
  locked_range<L>(p, sc, buf, rs, log_base, place);
}

// the kernel's instance for int32 (0) or packed (1) reads
using Kernel = void (*)(const Params);
const Kernel kKernels[2] = {locked_tail_kernel<Layout<false>>,
                            locked_tail_kernel<Layout<true>>};

// co-resident blocks of each instance on each device, queried once
int g_max_blocks[2][kMaxDevices];

}  // namespace

extern "C" long long locked_tail_scratch(int C, int Kn, int n_narrow, int Nn,
                                         int n_locked, int R) {
  return scratch_ints(C, Kn, n_narrow, Nn, n_locked, R);
}

// The grid a launch of the instance for packed or int32 reads will use for
// C slots: at most the blocks co-resident on the current device (queried
// once a device), no more than the largest pool's tiles. Returns -(CUDA
// error) on failure.
extern "C" int locked_tail_grid(int C, int packed) {
  const int slot = packed ? 1 : 0;
  return coop_grid(kKernels[slot], g_max_blocks[slot], n_tiles(C));
}

#ifdef K3_STAMPS
// the grid syncs of the last launch (g_syncs) into host
extern "C" int locked_tail_syncs(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_syncs, sizeof(g_syncs));
}

// the stamps of the last launch, (kStampSteps, 3, kStampPts) u64, into
// host: the hole-allocated steps' (narrow != 0) or the locked steps'
// every hole-allocated tile's publish times of the last launch,
// (kStampSteps, kPubTiles, kPubPts) u64, into host
extern "C" int locked_tail_pubs(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_npub, sizeof(g_npub));
}

extern "C" int locked_tail_stamps(void* host, int narrow) {
  return narrow ? (int)cudaMemcpyFromSymbol(host, g_nstamps,
                                            sizeof(g_nstamps))
                : (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
#endif

// The registers a thread, local (spill) bytes a thread and static shared
// bytes a block of the kernel's instance for packed or int32 reads, into
// out[0:3]; returns the CUDA error.
extern "C" int locked_tail_attrs(int* out, int packed) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kKernels[packed ? 1 : 0]);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" int locked_tail(
    const void* rid_in, const void* lo_in, const void* hi_in,
    const void* pref_in, const void* ovf_in, int n_in,
    const void* reads, const void* packed, const void* row_len, int k,
    int total, int step0, int R, int n_narrow, int Nn, int Gn, int Wn,
    int lock, int n_locked, int G, int W,
    const void* narrow_tab, int n, const void* occ, const void* blocks,
    const void* sym_start, const void* sentinel_row,
    const void* mrl, int n_mrl, const void* out_lo, const void* out_hi,
    int L, int B, int log_base, void* lp, void* le,
    void* carry, int C, void* ovf, void* scratch, int grid, void* stream) {
  Params p;
  p.x.narrow_tab = static_cast<const int*>(narrow_tab);
  p.x.occ = static_cast<const int4*>(occ);
  p.x.n = n;
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
  p.rd = Reads{static_cast<const int*>(reads),
               static_cast<const unsigned char*>(packed),
               static_cast<const int*>(row_len), k, total, step0, R};
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
      (const void*)kKernels[packed != nullptr ? 1 : 0],
      dim3(grid), dim3(kThreads), args, 0,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
