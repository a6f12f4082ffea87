// The SA-range-sharded index's scan (K10) on Hopper (sm_90a), in gather
// rounds: every card of a mesh row steps the same pool, gathers only from
// the index shards it holds, and the row's cards sum their answers between
// two launches (ops/sharded.py: an NCCL all-reduce on the cards' streams).
//
// Replaces gramtools_tpu/parallel/sharded_index.py::shard_fn (:95-119): its
// occ_rows and narrow_rows, a masked local gather on each "idx" shard and a
// psum over the axis (XLA on the TPU), with the steps they serve
// (search_jax_log.py::_build_log_step, _build_narrow_step, _resize_pool and
// _lock_pool, which K2 and K3 run on the replicated index). Each step has
// two gather rounds, the second depending on the first:
//   * a wide step: round 1 the LF rows occ_rows([lo, hi + 1]) of its
//     active states (search_jax_log.py:110), round 2 the newborns'
//     occ_rows([j_lo, j_hi + 1]) (:173);
//   * a narrow step, hole-allocated or slot-locked: round 1 the narrow word
//     narrow_rows(lo) of its single states (:298) with the wide sub-path's
//     occ rows of its first W wide states (:312), both of the incoming
//     carry; round 2 the newborns' rows (:378).
// A launch runs from one round's answers to the next round's masked local
// gather, so a launch boundary takes the place of every wait that spans a
// gather. No kernel reads another card's memory or waits on a word that
// another card writes; the cards are ordered by their streams and the
// collectives alone:
//   * sharded_open_kernel finishes step s from its round-2 answers (each
//     newborn's interval; its rank by a chained scan over the step's pairs;
//     its place: after the survivors in a wide step, in the hole of its
//     rank in a hole-allocated one, in its read's own slot in a locked
//     one), then materialises the carry of step s + 1 (with _resize_pool
//     or _lock_pool at a phase's start) and gathers its round-1 rows, the
//     narrow steps' wide rank by a chained scan; the first launch copies
//     the carry in, the last writes the final carry;
//   * sharded_mid_kernel runs step s from its round-1 answers up to its
//     round-2 gather: the LF or the merged narrow extension, keep, the
//     marker hits, the chained scan of the payload (survivors or holes,
//     hits, the last slot with hits and its pref), the survivors or every
//     slot's own row, the spilled flags, then the tile's hit pairs within
//     the budget (log records in place; owner, locus and outcome bounds by
//     pair_head) and their masked gather; the tile that closes the step
//     writes the empty hit records.
// A card gathers what the step reads of a row, not the row: the LF's
// (channel base, DNA total) at both ends, the narrow word, a newborn's
// channel at both bounds. Row r belongs to shard r / rps; a card adds the
// value of each shard it holds that owns the row, zero for the others
// (its masked gathers, summed over its shards), so the sum over the row's
// cards is the owner's value, the replicated scan's bit for bit. One card
// holding every shard of the row makes no collective.
//
// The step rules are K2's and K3's (scan_common.cuh: lf_of, narrow_merge,
// pair_head, block_scan, count_scan, payload_scan; the budgets and the
// dump-slot flags as the torch steps, mapping/scan_steps.py, set them). A
// chained scan waits only on tiles before it in the same launch; blocks
// take their tiles in order and the cooperative launch makes every block
// co-resident, so the least tile not done waits on finished tiles only.
// Each launch zeroes the descriptors of the next; the first zeroes both
// sets behind a grid sync.
//
// What bounds it on the card: a round trip a round, not bytes. A step is
// two launches, each a chain of dependent loads a tile and one to four grid
// syncs, and across cards an all-reduce between them: 2 x steps + 1
// launches and, across cards, 2 x steps collectives a scan (289 and 288 at
// the 144-step plan of a 150 bp read), against K2 and K3's two launches on
// the replicated index.
//
// C interface for ctypes (no PyTorch headers): sharded_setup fills a
// context (host memory the wrapper owns) with one card's pointers and the
// plan's step table; sharded_launch launches launch i of the scan on the
// card and stream given and returns the CUDA error, 0 on success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace scan_dev;
using Rows = Layout<false>;              // int32 read rows

constexpr int kMaxShards = 8;            // shards of a table on one card
constexpr int kWide = 0, kNarrow = 1, kLocked = 2, kNone = -1;
constexpr int kNoHole = 0x7FFFFFFF;      // a kept slot's hole rank
constexpr int kStepInts = 8;             // ints a row of the step table

// one step of the plan (a row of the step table)
struct Step {
  int kind;           // kWide, kNarrow, kLocked, or kNone
  int N, G, W;        // pool, hit budget, wide budget
  int log_base;       // its first log record
  int rs;             // its row of the read matrix
  int cur;            // the carry buffer it reads (it writes cur ^ 1)
  int lock;           // _lock_pool before it
};

// this card's shards of the occ and narrow tables
struct Shards {
  const int4* occ[kMaxShards];   // (rps, 4) each
  const int* nt[kMaxShards];     // (nt_rps,) each
  int id[kMaxShards];            // their shard indices, -1 past them
  int rps, nt_rps;
};

struct Params {
  Index x;                       // sym_start .. B and n (occ, narrow: null)
  Shards h;
  Reads rd;                      // (steps, R) int32
  int R;
  const int* rid_in;             // (n_in,) carry in, never written
  const int* lo_in;
  const int* hi_in;
  const int* pref_in;
  const unsigned char* ovf_in;   // (R + 1,)
  int n_in;
  int* carry;                    // (2, 4, C)
  int C;
  unsigned char* ovf;            // (R + 1,)
  int* lp;                       // the whole log
  int* le;
  // scratch
  int* ans1;                     // round 1: (4 N,) or (N4 + 4 W,) ints
  int2* ans2;                    // round 2: (K,) a pair's two channels
  int2* meta;                    // (K,) a pair's owner read (-1: no rows),
                                 // base
  int4* stage;                   // (K,) newborns by rank (narrow)
  int4* nbv;                     // (C,) a slot's first newborn (locked)
  int* wrank;                    // (C,) each slot's wide rank
  int* hrank;                    // (C,) each slot's hole rank
  int* nb;                       // (C,) newborns a slot, the lock's counts
  int* totals;                   // [survivors or holes, candidates]
  unsigned long long* desc;      // (2, area) descriptor sets
  long long area;
  int K;                         // pairs of the largest step
  // this launch
  Step prev, next;
  int first;                     // copy the carry in
  int par;                       // its descriptor set
};

// the descriptors of one set: the candidate count words (tiles of pairs),
// the wide count words and the payload descriptors (tiles of slots)
__host__ __device__ inline long long area_words(int C, int K) {
  return (long long)n_tiles(K) + (long long)(1 + kDescWords) * n_tiles(C);
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// ---- the masked local gathers ---------------------------------------------

template <class T>
__device__ __forceinline__ T pick(T const (&a)[kMaxShards], int j) {
  T v = a[0];                    // selects: a dynamic index would copy the
#pragma unroll                   // parameters to local memory
  for (int i = 1; i < kMaxShards; ++i)
    if (j == i) v = a[i];
  return v;
}

// this card's slot of shard s, or -1
__device__ __forceinline__ int local_slot(const Shards& h, int s) {
  int j = -1;
#pragma unroll
  for (int i = 0; i < kMaxShards; ++i)
    if (h.id[i] == s) j = i;
  return j;
}

// occ row r (clamped to [0, n]) where this card holds its owner, else 0
__device__ __forceinline__ int4 masked_occ(const Params& p, int r) {
  r = clampi(r, 0, p.x.n);
  const int s = r / p.h.rps;
  const int j = local_slot(p.h, s);
  return j < 0 ? make_int4(0, 0, 0, 0)
               : __ldg(pick(p.h.occ, j) + (r - s * p.h.rps));
}

// narrow word r (clamped to [0, n - 1]) where this card holds its owner
__device__ __forceinline__ int masked_narrow(const Params& p, int r) {
  r = clampi(r, 0, p.x.n - 1);
  const int s = r / p.h.nt_rps;
  const int j = local_slot(p.h, s);
  return j < 0 ? 0 : __ldg(pick(p.h.nt, j) + (r - s * p.h.nt_rps));
}

// an LF's round-1 answer: (channel base, DNA total) at lo and at hi + 1
__device__ __forceinline__ int4 masked_lf(const Params& p, int lo, int hi,
                                          int base) {
  const int4 a = masked_occ(p, lo), b = masked_occ(p, add_wrap(hi, 1));
  return make_int4(chan(a, base), a.x + a.y + a.z + a.w, chan(b, base),
                   b.x + b.y + b.z + b.w);
}

// the LF of [lo, hi] by base from its summed answer
__device__ __forceinline__ LF answer_lf(const Params& p, int4 a, int lo,
                                        int hi, int base, int sent) {
  return lf_of(lo, add_wrap(hi, 1), make_int2(a.x, a.y), make_int2(a.z, a.w),
               __ldg(p.x.sym_start + clampi(base, 0, 4)), sent);
}

// a narrow step's round-1 wide rows, after its N narrow words
__device__ __forceinline__ int4* wide_answers(const Params& p, int N) {
  return reinterpret_cast<int4*>(p.ans1 + round4(N));
}

// ---- sharded_open_kernel: the end of step s, the start of step s + 1 ------

struct OpenShared {
  int first[5];                  // sym_start
  int excl;                      // a look-back's broadcast
};

// Step s's newborns from its round-2 answers, a thread a pair in tiles of
// pairs (cd: the candidate count words): a wide step's after its survivors
// (slot survivors + rank), a hole-allocated one's staged at their rank, a
// locked one's counted into its owner's slot (the first one's interval and
// pref kept); a newborn past the room flags its read.
__device__ void finish_pairs(const Params& p, OpenShared& ts,
                             unsigned long long* cd) {
  const Step& s = p.prev;
  const int K = s.G * p.x.B, T = n_tiles(K), x = threadIdx.x;
  const Carry nxt = carry_at(p.carry, s.cur ^ 1, p.C);
  const int n_own = p.totals[0];         // survivors (wide) or holes
  const int room = s.kind == kWide ? max(s.N - n_own, 0) : min(n_own, K);
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int k = tile * kThreads + x;
    bool ok = false;
    int4 born = make_int4(0, 0, 0, 0);
    if (k < K) {
      const int2 m = p.meta[k], a = p.ans2[k];
      const int f = ts.first[clampi(m.y, 0, 4)];
      born = make_int4(m.x, f + a.x, f + a.y - 1, s.log_base + k);
      ok = m.x >= 0 && born.y <= born.z;
    }
    if (s.kind == kLocked) {
      if (ok && atomicAdd(p.nb + born.x, 1) == 0)
        p.nbv[born.x] = make_int4(born.y, born.z, born.w, 0);
      continue;
    }
    int n_c;
    const int r = block_scan(ok ? 1 : 0, &n_c);
    if (x >= kLead) {
      const int e = count_scan(cd, tile, n_c);
      if (x == kLead) ts.excl = e;
    }
    __syncthreads();
    const int c = ts.excl + r;
    if (ok) {
      if (c >= room) p.ovf[born.x] = 1;
      else if (s.kind == kWide) put_row(nxt, n_own + c, born);
      else p.stage[c] = born;
    }
    if (tile == T - 1 && x == kLead) p.totals[1] = ts.excl + n_c;
    __syncthreads();                     // ts is the next tile's
  }
}

// Slot i of the carry after step s (or of the carry in): the survivors and
// newborns of a wide step (empty slots past them), each slot's own row with
// the newborn of its hole rank of a hole-allocated step, a locked step's
// own row or sole newborn (a conflict clears the read and flags it).
__device__ __forceinline__ int4 carry_after(const Params& p, int i, int n_own,
                                            int n_cand) {
  const Step& s = p.prev;
  if (s.kind == kNone) {
    return i < p.n_in ? make_int4(__ldg(p.rid_in + i), __ldg(p.lo_in + i),
                                  __ldg(p.hi_in + i), __ldg(p.pref_in + i))
                      : fill_row();
  }
  const Carry b = carry_at(p.carry, s.cur ^ 1, p.C);
  if (s.kind == kWide)
    return i < min(s.N, n_own + n_cand) ? carry_row(b, i) : fill_row();
  int4 v = carry_row(b, i);
  if (s.kind == kNarrow) {
    const int h = p.hrank[i];
    if (h < min(n_cand, min(n_own, s.G * p.x.B))) v = p.stage[h];
    return v;
  }
  const int c = p.nb[i];
  const bool keep = v.x >= 0;
  const bool conflict = c > 1 || (c == 1 && keep);
  if (c == 1 && !keep) {
    const int4 nb = p.nbv[i];
    v = make_int4(i, nb.x, nb.y, nb.z);
  }
  if (conflict) {
    v.x = -1;
    p.ovf[i] = 1;
  }
  return v;
}

// _lock_pool: src (n_src states) -> dst (R slots), three passes behind grid
// syncs, p.nb the reads' live states
__device__ void lock_carry(const Params& p, Carry src, int n_src, Carry dst,
                           cg::grid_group& grid) {
  const int R = p.R;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  for (int i = tid; i < R; i += nthreads) p.nb[i] = 0;
  grid.sync();
  for (int j = tid; j < n_src; j += nthreads) {
    const int r = src.rid[j];
    if (r >= 0) atomicAdd(p.nb + clampi(r, 0, R - 1), 1);
  }
  grid.sync();
  // slot i is written by its placed state or, if none, with the fill:
  // exactly one writer either way
  for (int i = tid; i < max(n_src, R); i += nthreads) {
    if (i < R) {
      const int c = p.nb[i];
      if (c > 1) p.ovf[i] = 1;
      if (c != 1) put_row(dst, i, make_int4(-1, 0, 0, 0));
    }
    if (i < n_src) {
      const int r = src.rid[i];
      const int rc = clampi(r, 0, R - 1);
      if (r >= 0 && p.nb[rc] == 1)
        put_row(dst, rc, make_int4(rc, src.lo[i], src.hi[i], src.pref[i]));
    }
  }
}

// Step s + 1's round-1 gather from its carry: a wide step's LF answers a
// slot; a narrow step's narrow word a slot and, by the wide rank (a chained
// scan over wd), the LF answers of its first W wide states.
__device__ void gather_round1(const Params& p, OpenShared& ts,
                              unsigned long long* wd) {
  const Step& s = p.next;
  const int N = s.N, T = n_tiles(N), R = p.R, x = threadIdx.x;
  const Carry cur = carry_at(p.carry, s.cur, p.C);
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int i = tile * kThreads + x;
    const bool in = i < N;
    const int4 c = in ? carry_row(cur, i) : fill_row();
    const bool valid = c.x >= 0;
    const int rc = s.kind == kLocked ? min(i, R - 1) : clampi(c.x, 0, R - 1);
    const int base = valid ? read_base<Rows>(p.rd, s.rs, rc) : 0;
    const bool active = valid && base > 0;
    if (s.kind == kWide) {
      if (in)
        reinterpret_cast<int4*>(p.ans1)[i] =
            active ? masked_lf(p, c.y, c.z, base) : make_int4(0, 0, 0, 0);
      continue;
    }
    const bool single = c.y == c.z;
    const bool wide = active && !single;
    if (in) p.ans1[i] = valid && single ? masked_narrow(p, c.y) : 0;
    int n_wide;
    const int r = block_scan(wide ? 1 : 0, &n_wide);
    if (x >= kLead) {
      const int e = count_scan(wd, tile, n_wide);
      if (x == kLead) ts.excl = e;
    }
    __syncthreads();
    const int w_rank = ts.excl + r;
    if (in) p.wrank[i] = wide ? w_rank : -1;
    if (wide && w_rank < s.W)
      wide_answers(p, N)[w_rank] = masked_lf(p, c.y, c.z, base);
    __syncthreads();                     // ts is the next tile's
  }
}

__global__ void __launch_bounds__(kThreads) sharded_open_kernel(
    const Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ OpenShared ts;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const int R = p.R;
  unsigned long long* area = p.desc + (size_t)p.par * p.area;
  if (threadIdx.x < 5) ts.first[threadIdx.x] = __ldg(p.x.sym_start +
                                                     threadIdx.x);
  if (p.first) {             // both descriptor sets zeroed, the flags in
    for (long long i = tid; i < 2 * p.area; i += nthreads) p.desc[i] = 0;
    for (int i = tid; i <= R; i += nthreads) p.ovf[i] = p.ovf_in[i];
    grid.sync();
  } else {                   // the next launch's set zeroed
    unsigned long long* other = p.desc + (size_t)(p.par ^ 1) * p.area;
    for (long long i = tid; i < p.area; i += nthreads) other[i] = 0;
    __syncthreads();
  }
  const Step& s = p.prev;
  const Step& nx = p.next;
  int n_src = p.n_in;
  if (s.kind != kNone) {
    finish_pairs(p, ts, area);
    grid.sync();
    n_src = s.N;
    // a hole-allocated step's unflagged hit pairs set the dump slot
    const int K = s.G * p.x.B;
    if (s.kind == kNarrow && tid == 0 &&
        K > max(p.totals[1] - min(p.totals[0], K), 0))
      p.ovf[R] = 1;
  }
  // the next carry, materialised in buffer m (the last step's output
  // buffer; with a lock the other buffer, which the lock fills), resized
  // to the next pool unless a lock follows: the slots a shrink cuts off
  // flag their read (an empty one the dump slot)
  const int m = s.kind != kNone ? (s.cur ^ 1) : (nx.cur ^ nx.lock);
  const int n_to = nx.kind != kNone && !nx.lock ? nx.N : n_src;
  const int n_own = p.totals[0], n_cand = p.totals[1];
  const Carry dst = carry_at(p.carry, m, p.C);
  for (int i = tid; i < max(n_src, n_to); i += nthreads) {
    const int4 v = i < n_src ? carry_after(p, i, n_own, n_cand) : fill_row();
    if (i < n_to) {
      put_row(dst, i, v);
    } else if (v.x < 0) {
      p.ovf[R] = 1;
    } else if (v.x <= R) {
      p.ovf[v.x] = 1;
    }
  }
  if (nx.kind == kNone) return;
  grid.sync();
  if (nx.lock) {
    lock_carry(p, dst, n_src, carry_at(p.carry, nx.cur, p.C), grid);
    grid.sync();
  }
  gather_round1(p, ts, area + n_tiles(p.K));
}

// ---- sharded_mid_kernel: step s from round 1 to round 2 --------------------

struct MidShared {
  PairTile pt;               // incl, hit, base, single, pref, first
  int rc[kThreads];          // each slot's read, clamped
  int warp_last[kWarps];     // the last slot with hits in each warp
  Payload excl, inc;         // the look-back's broadcasts
};

// One tile of step s (p.next) over its N slots (port of _build_log_step
// and _build_narrow_step up to the newborns' rows); pd: the step's payload
// descriptors.
__device__ void mid_tile(const Params& p, MidShared& ts, int tile, int T,
                         unsigned long long* pd, int sent) {
  const Step& s = p.next;
  const int R = p.R, B = p.x.B, x = threadIdx.x, N = s.N, G = s.G;
  const int i = tile * kThreads + x;
  const bool in = i < N;
  const Carry cur = carry_at(p.carry, s.cur, p.C);
  const Carry nxt = carry_at(p.carry, s.cur ^ 1, p.C);
  const int4 c = in ? carry_row(cur, i) : fill_row();
  const int rid = c.x, lo = c.y, hi = c.z, pref = c.w;
  const bool valid = rid >= 0;
  const int rc = s.kind == kLocked ? min(i, R - 1) : clampi(rid, 0, R - 1);
  const int base = valid ? read_base<Rows>(p.rd, s.rs, rc) : 0;
  const bool active = valid && base > 0;
  bool single = false, spill_w = false;
  Merged m;
  if (s.kind == kWide) {
    LF w = {0, 0, 0, 0};
    if (active)
      w = answer_lf(p, reinterpret_cast<const int4*>(p.ans1)[i], lo, hi,
                    base, sent);
    m.keep = (active && w.nlo <= w.nhi) || (valid && !active);
    m.klo = active ? w.nlo : lo;
    m.khi = active ? w.nhi : hi;
    m.cnt = active ? w.mhi - w.mlo : 0;
    m.hit = w.mlo;
  } else {
    single = lo == hi;
    const bool wide = active && !single;
    const int t = valid && single ? p.ans1[i] : 0;
    const int w_rank = wide ? p.wrank[i] : 0;
    const bool cov = wide && w_rank < s.W;
    spill_w = wide && !cov;
    LF w = {0, 0, 0, 0};                 // wball: 0 unless covered
    if (cov) w = answer_lf(p, wide_answers(p, N)[w_rank], lo, hi, base, sent);
    m = narrow_merge(valid, active, single, cov, base, t, w, lo, hi);
  }
  const int cnt = m.cnt;
  const bool hole = in && !m.keep;
  const unsigned with_hits = __ballot_sync(kAll, cnt > 0);
  if ((x & 31) == 0)
    ts.warp_last[x >> 5] = with_hits ? x + 31 - __clz(with_hits) : -1;
  int n_own, tile_cnt;
  const int own_rank = block_scan(s.kind == kWide ? m.keep : hole, &n_own);
  const int excl = block_scan(cnt, &tile_cnt);
  ts.pt.incl[x] = excl + cnt;
  ts.pt.hit[x] = m.hit;
  ts.pt.base[x] = base;
  ts.pt.single[x] = single;
  ts.pt.pref[x] = pref;
  ts.rc[x] = rc;
  __syncthreads();

  // the payload's chained scan by the last warp
  if (x >= kLead) {
    int last = -1;
    for (int w = 0; w < kWarps; ++w) last = max(last, ts.warp_last[w]);
    const Payload agg = {n_own, tile_cnt,
                         last < 0 ? -1 : tile * kThreads + last,
                         last >= 0 ? ts.pt.pref[last]
                                   : (tile == 0 ? ts.pt.pref[0] : 0)};
    Payload inc;
    const Payload e = payload_scan(pd, tile, agg, true, &inc);
    if (x == kLead) {
      ts.excl = e;
      ts.inc = inc;
    }
  }
  __syncthreads();
  const Payload e = ts.excl;

  // survivors at their rank (wide), every slot's own row (narrow)
  if (s.kind == kWide) {
    if (in && m.keep)
      put_row(nxt, e.n + own_rank, make_int4(rid, m.klo, m.khi, pref));
  } else if (in) {
    put_row(nxt, i, make_int4(m.keep ? rid : -1, m.klo, m.khi, pref));
    if (s.kind == kNarrow) p.hrank[i] = hole ? e.n + own_rank : kNoHole;
    else p.nb[i] = 0;
  }
  const bool spilled = active && e.sum + excl + cnt > G && cnt > 0;
  const bool flagged = spilled || spill_w;
  if (flagged) p.ovf[rc] = 1;
  // the twin's scatter routes a hole-allocated step's unflagged slot's flag
  // to the dump slot
  if (s.kind == kNarrow && __syncthreads_or(in && !flagged) && x == 0)
    p.ovf[R] = 1;

  // the tile's pairs within the budget: log records, the newborns' rows
  const int g_end = tile_cnt > G - e.sum ? G : e.sum + tile_cnt;
  const int n_ok = g_end > e.sum ? (g_end - e.sum) * B : 0;
  const int k0 = n_ok > 0 ? e.sum * B : 0;
  for (int q = x; q < n_ok; q += kThreads) {
    Pair r = {0, 0, 0, false, 0, 0};
    int j_lo = -1, j_hi1 = 0;
    pair_head(p.x, ts.pt, q, &r, &j_lo, &j_hi1);
    const int k = k0 + q, jb = ts.pt.base[r.s];
    p.lp[s.log_base + k] = ts.pt.pref[r.s];
    p.le[s.log_base + k] = r.li * B + r.b;
    const bool rows = j_lo >= 0;
    p.meta[k] = make_int2(rows ? ts.rc[r.s] : -1, jb);
    p.ans2[k] = rows ? make_int2(chan(masked_occ(p, j_lo), jb),
                                 chan(masked_occ(p, j_hi1), jb))
                     : make_int2(0, 0);
  }
  // the empty hit records [min(total, G), G) x B, by the tile that closes
  // the step (the last slot with hits' pref, slot 0's when there is none)
  if (tile == T - 1) {
    const Payload inc = ts.inc;
    for (int k = min(inc.sum, G) * B + x; k < G * B; k += kThreads) {
      p.lp[s.log_base + k] = inc.pref;
      p.le[s.log_base + k] = k % B;               // locus clamped to 0
      p.meta[k] = make_int2(-1, 0);
      p.ans2[k] = make_int2(0, 0);
    }
    if (x == 0) p.totals[0] = inc.n;
  }
  __syncthreads();                       // ts is the next tile's
}

__global__ void __launch_bounds__(kThreads) sharded_mid_kernel(
    const Params p) {
  __shared__ MidShared ts;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  unsigned long long* other = p.desc + (size_t)(p.par ^ 1) * p.area;
  for (long long i = tid; i < p.area; i += nthreads) other[i] = 0;
  if (threadIdx.x < 5) ts.pt.first[threadIdx.x] = __ldg(p.x.sym_start +
                                                        threadIdx.x);
  // a wide step routes its survivors' unset flags to the dump slot
  if (p.next.kind == kWide && tid == 0) p.ovf[p.R] = 1;
  const int sent = __ldg(p.x.sentinel_row);
  const int T = n_tiles(p.next.N);
  unsigned long long* pd = p.desc + (size_t)p.par * p.area + n_tiles(p.K)
                           + n_tiles(p.C);
  __syncthreads();
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x)
    mid_tile(p, ts, tile, T, pd, sent);
}

// a card's scan: its parameters and the plan's step table
struct Context {
  Params p;
  const int* table;          // (n_steps, kStepInts)
  int n_steps;
  int device;
};

// co-resident blocks of each kernel on each device, queried once
int g_max_blocks[2][kMaxDevices];

Step step_of(const Context& c, int s) {
  if (s < 0 || s >= c.n_steps) return Step{kNone, 0, 0, 0, 0, 0, 0, 0};
  const int* t = c.table + (size_t)s * kStepInts;
  return Step{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7]};
}

}  // namespace

extern "C" int sharded_context_bytes() { return (int)sizeof(Context); }

// The scratch ints a card's scan needs: the round-1 answers (a1 ints, a
// multiple of 4), the round-2 answers, the pairs' heads, the stage and the
// newborns (K pairs), the slots' arrays (C slots), the totals and both
// descriptor sets; every array 16-byte aligned.
extern "C" long long sharded_scratch_ints(int C, int K, int a1) {
  return (long long)a1 + 2LL * round4(2 * K) + 4LL * K + 4LL * C
         + 3LL * round4(C) + 4 + 4LL * area_words(C, K);
}

// Fills ``ctx`` (sharded_context_bytes of host memory) for one card's
// scan. occ and nt: the card's n_local shards of each table (none: it
// gathers zeros), ids their shard indices; table: the plan's (n_steps, 8)
// step rows (kind, pool, hits, wide budget, log base, read row, carry
// buffer read, lock), which must outlive the scan. Returns cudaErrorInvalidValue on arguments the
// kernels do not take, else 0.
extern "C" int sharded_setup(
    void* ctx, int device, const void* const* occ, const void* const* nt,
    const int* ids, int n_local, int rps, int nt_rps, int n,
    const void* sym_start, const void* sentinel_row, const void* mrl,
    int n_mrl, const void* out_lo, const void* out_hi, int L, int B,
    const void* reads, int steps, int R, const void* rid_in,
    const void* lo_in, const void* hi_in, const void* pref_in,
    const void* ovf_in, int n_in, void* carry, int C, void* ovf, void* lp,
    void* le, void* scratch, int K, int a1, const int* table, int n_steps) {
  if (n_local < 0 || n_local > kMaxShards || rps < 1 || nt_rps < 1 || a1 % 4)
    return (int)cudaErrorInvalidValue;
  Context& c = *static_cast<Context*>(ctx);
  Params& p = c.p;
  p.x.narrow_tab = nullptr;
  p.x.occ = nullptr;
  p.x.blocks = nullptr;
  p.x.n = n;
  p.x.sym_start = static_cast<const int*>(sym_start);
  p.x.sentinel_row = static_cast<const int*>(sentinel_row);
  p.x.mrl = static_cast<const int*>(mrl);
  p.x.n_mrl = n_mrl;
  p.x.out_lo = static_cast<const int*>(out_lo);
  p.x.out_hi = static_cast<const int*>(out_hi);
  p.x.L = L;
  p.x.B = B;
  for (int j = 0; j < kMaxShards; ++j) {
    const bool in = j < n_local;
    p.h.occ[j] = in ? static_cast<const int4*>(occ[j]) : nullptr;
    p.h.nt[j] = in ? static_cast<const int*>(nt[j]) : nullptr;
    p.h.id[j] = in ? ids[j] : -1;
  }
  p.h.rps = rps;
  p.h.nt_rps = nt_rps;
  p.rd = Reads{static_cast<const int*>(reads), nullptr, nullptr, 0, steps, 0,
               R};
  p.R = R;
  p.rid_in = static_cast<const int*>(rid_in);
  p.lo_in = static_cast<const int*>(lo_in);
  p.hi_in = static_cast<const int*>(hi_in);
  p.pref_in = static_cast<const int*>(pref_in);
  p.ovf_in = static_cast<const unsigned char*>(ovf_in);
  p.n_in = n_in;
  p.carry = static_cast<int*>(carry);
  p.C = C;
  p.ovf = static_cast<unsigned char*>(ovf);
  p.lp = static_cast<int*>(lp);
  p.le = static_cast<int*>(le);
  int* s = static_cast<int*>(scratch);
  p.ans1 = s;
  s += a1;
  p.ans2 = reinterpret_cast<int2*>(s);
  s += round4(2 * K);
  p.meta = reinterpret_cast<int2*>(s);
  s += round4(2 * K);
  p.stage = reinterpret_cast<int4*>(s);
  s += 4LL * K;
  p.nbv = reinterpret_cast<int4*>(s);
  s += 4LL * C;
  p.wrank = s;
  s += round4(C);
  p.hrank = s;
  s += round4(C);
  p.nb = s;
  s += round4(C);
  p.totals = s;
  s += 4;
  p.desc = reinterpret_cast<unsigned long long*>(s);
  p.area = area_words(C, K);
  p.K = K;
  c.table = table;
  c.n_steps = n_steps;
  c.device = device;
  return 0;
}

// Launches launch i (0 .. 2 n_steps) of the scan of ``ctx`` on its card,
// on ``stream``: even i the open kernel (the end of step i / 2 - 1, the
// start of step i / 2), odd i the mid kernel of step (i - 1) / 2. The
// current device is restored. Returns the CUDA error, 0 on success.
extern "C" int sharded_launch(const void* ctx, int i, void* stream) {
  const Context& c = *static_cast<const Context*>(ctx);
  if (i < 0 || i > 2 * c.n_steps) return (int)cudaErrorInvalidValue;
  Params p = c.p;
  const bool mid = i & 1;
  p.prev = mid ? step_of(c, -1) : step_of(c, i / 2 - 1);
  p.next = step_of(c, mid ? (i - 1) / 2 : i / 2);
  p.first = i == 0;
  p.par = i & 1;
  int prev_dev = 0;
  cudaError_t err = cudaGetDevice(&prev_dev);
  if (err != cudaSuccess) return (int)err;
  if (prev_dev != c.device && (err = cudaSetDevice(c.device)) != cudaSuccess)
    return (int)err;
  // the grid: the most tiles a pass of the launch has (its loops stride
  // over the grid, so any grid is right; a smaller one syncs sooner)
  int need = n_tiles(p.next.N);
  if (!mid) {
    const int more[3] = {n_tiles(p.prev.kind != kNone ? p.prev.N : p.n_in),
                         n_tiles(p.prev.G * p.x.B),
                         p.next.lock ? n_tiles(p.R) : 0};
    for (int t : more) need = t > need ? t : need;
  }
  const void* kernel = mid ? (const void*)sharded_mid_kernel
                           : (const void*)sharded_open_kernel;
  const int grid = mid ? coop_grid(sharded_mid_kernel, g_max_blocks[1], need)
                       : coop_grid(sharded_open_kernel, g_max_blocks[0],
                                   need);
  if (grid < 1) {
    err = (cudaError_t)(-grid);
  } else {
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads),
                                      args, 0,
                                      reinterpret_cast<cudaStream_t>(stream));
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (prev_dev != c.device) {
    const cudaError_t back = cudaSetDevice(prev_dev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// The registers a thread, local (spill) bytes a thread and static shared
// bytes a block of the open (0) or mid (1) kernel, into out[0:3]; returns
// the CUDA error.
extern "C" int sharded_attrs(int* out, int which) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, which ? (const void*)sharded_mid_kernel
                : (const void*)sharded_open_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}
