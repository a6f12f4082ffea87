// Device code shared by the scan's cooperative kernels: wide_step.cu (K2,
// the wide steps of gramtools_tpu/mapping/search_jax_log.py::
// _build_log_step), locked_step.cu (K3, the hole-allocated and the
// slot-locked narrow steps of _build_narrow_step) and sharded_step.cu (the
// same steps in gather rounds over an SA-range-sharded index, K10).
//
// Both run one thread a pool slot in tiles of kThreads slots; a block owns
// tiles place, place + gridDim.x, ... of a step (its place: consecutive
// places on distinct SMs) and takes them in increasing order. What they
// share:
//   * the index tables (Index) and the occ-row fetch, from the dense
//     (n + 1, 4) table or through K1's per-row count (packed_rank.cuh);
//   * the read matrix (Reads): int32 base rows, or the 2-bit packed rows
//     decoded where a base is loaded (K6);
//   * Layout: K2 and K3 are built in two instances, for int32 or packed
//     rows, so that an instance carries only the loads its launch makes;
//   * lf_extend and lf_of: the LF extension of [lo, hi] by one base and the
//     marker counts at both ends (scan_steps._lf_extend), from the two occ
//     rows' (channel base, DNA total); narrow_merge: a narrow step's
//     merged extension of a single or a covered wide state;
//   * block_scan: a block's exclusive scan with warp shuffles;
//   * the chained scans with decoupled look-back (Merrill and Garland,
//     NVIDIA 2016) that rank a step's slots across tiles without a grid
//     barrier: a count word (state << 32 | count) and a payload descriptor
//     (a count, the marker hits, the last slot with hits and its pref),
//     each field a word of its own with the state beside it, so a reader
//     needs one round trip and no memory ordering; a wait past ~seconds
//     traps. Every rank equals the integer cumsum the torch twin takes;
//   * a tile's hit pairs by its own block (pair_head, tile_pair): a pair
//     finds its owner by a binary search over the tile's prefix of marker
//     hits in shared memory, its jump locus, and its newborn's LF, by a team of
//     1 or 4 lanes (each lane counting the newborn's base in its code
//     vectors of a packed occ record); staged_pairs writes each pair's log record in place and
//     compacts the tile's newborn candidates in pair order;
//   * resize: _resize_pool on the carry, in place;
//   * the probe builds' stage stamps and grid-sync counts.
// Every clamp of the JAX code is kept; its dropped writes write nothing.

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_rank.cuh"

namespace scan_dev {

constexpr int kThreads = 256;             // slots a tile, threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xFFFFFFFFu;

// Stage stamps of a probe build (-DK2_STAMPS, -DK3_STAMPS; never the
// path's build): the global timer at up to kStampPts points of each of the
// first kStampSteps steps of a range, for three tiles (0, T / 2, T - 1)
constexpr int kStampSteps = 256, kStampPts = 10;

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the stamp row of tile ``tile`` of T, or -1 for a tile not stamped
__device__ __forceinline__ int stamp_row(int tile, int T) {
  return tile == 0 ? 0 : tile == T / 2 ? 1 : tile == T - 1 ? 2 : -1;
}

__device__ __forceinline__ void stamp_at(unsigned long long* stamps, int k,
                                         int step, int tile, int T) {
  const int sel = stamp_row(tile, T);
  if (sel < 0 || step >= kStampSteps) return;
  stamps[(step * 3 + sel) * kStampPts + k] = global_timer();
}

// Each tile's times of the first kStampSteps steps, for the first
// kPubTiles tiles, in a probe build: the global timer into pub[(step ·
// kPubTiles + tile) · kPubPts + k], k: 0 its payload published, 1 its
// candidate count published, 2 its start, 3 its carry and base loaded, 4
// its LF done (the last three by its thread 0; K2 only); and at k = 5 the
// SM its block runs on
constexpr int kPubTiles = 1024, kPubPts = 6;

__device__ __forceinline__ void pub_at(unsigned long long* pub, int k,
                                       int step, int tile) {
  if (step < kStampSteps && tile < kPubTiles) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* e = pub + ((size_t)step * kPubTiles + tile) * kPubPts;
    e[k] = global_timer();
    e[5] = sm;
  }
}

// Grid syncs of the launch, counted only in a probe build: [0] in the
// scan steps' range (the wide steps; K3's start and hole-allocated steps),
// [1] after it (K3's lock and locked range). Block 0's thread 0 counts, so
// the count needs no atomics; it zeroes them at the launch's start.
#if defined(K2_STAMPS) || defined(K3_STAMPS)
__device__ unsigned long long g_syncs[2];
#endif

template <class Grid>
__device__ __forceinline__ void grid_sync(Grid& grid, int range) {
#if defined(K2_STAMPS) || defined(K3_STAMPS)
  if (blockIdx.x == 0 && threadIdx.x == 0) ++g_syncs[range];
#endif
  grid.sync();
}

__device__ __forceinline__ void zero_syncs() {
#if defined(K2_STAMPS) || defined(K3_STAMPS)
  if (blockIdx.x == 0 && threadIdx.x == 0) g_syncs[0] = g_syncs[1] = 0;
#endif
}

// the DeviceIndex tables a step reads (the sharded scan, sharded_step.cu,
// reads its own card's shards of occ and narrow_tab and leaves both null)
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

// What a kernel instance is compiled for: packed or int32 read rows. The
// wrappers launch the instance their arguments need, so the path's build
// (packed reads) carries no int32-row load.
template <bool Packed>
struct Layout {
  static constexpr bool kPacked = Packed;
};

// dense occ row r, clamped to [0, n] as the gather clamps it
template <class L>
__device__ __forceinline__ int4 occ_row(const Index& x, int r) {
  return __ldg(x.occ + (r < 0 ? 0 : (r > x.n ? x.n : r)));
}

// the address of narrow-table row r, clamped to [0, n - 1]
template <class L>
__device__ __forceinline__ const int* narrow_at(const Index& x, int r) {
  return x.narrow_tab + (r < 0 ? 0 : (r > x.n - 1 ? x.n - 1 : r));
}

// The read matrix a launch steps through: int32 base rows (steps, R), or
// the 2-bit packed rows (ceil(total / 4), R) uint8, 4 bases a byte along
// the step axis (code = base - 1), decoded where a base is loaded (K6,
// gramtools_tpu/mapping/search_jax_log.py::_unpack_reads2): global step g
// = step0 + s of read rc has base ((byte >> 2 (g & 3)) & 3) + 1 while g <
// clamp(row_len[rc] - k, 0, total), else 0 (inactive).
struct Reads {
  const int* rows;               // (steps, R) int32 (Layout<false, *>)
  const unsigned char* packed;   // (ceil(total / 4), R) uint8 (<true, *>)
  const int* row_len;            // (R,) int32, with packed
  int k;                         // kmer size
  int total;                     // the packed matrix's steps
  int step0;                     // the launch's first step in it
  int R;
};

// the base of read rc (in [0, R)) at the launch's step s
template <class L>
__device__ __forceinline__ int read_base(const Reads& r, int s, int rc) {
  if constexpr (!L::kPacked) {
    return __ldg(r.rows + (size_t)s * r.R + rc);
  } else {
    const int g = r.step0 + s;                // < total: both loads at once
    const unsigned b = __ldg(r.packed + (size_t)(g >> 2) * r.R + rc);
    const int len = __ldg(r.row_len + rc) - r.k;
    const int body = len < 0 ? 0 : (len > r.total ? r.total : len);
    return g < body ? (int)((b >> (2 * (g & 3))) & 3u) + 1 : 0;
  }
}

// the address read_base loads the base of read rc at step s from
template <class L>
__device__ __forceinline__ const void* read_addr(const Reads& r, int s,
                                                 int rc) {
  if constexpr (!L::kPacked)
    return r.rows + (size_t)s * r.R + rc;
  else
    return r.packed + (size_t)((r.step0 + s) >> 2) * r.R + rc;
}

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

__device__ __forceinline__ int4 carry_row(const Carry& c, int i) {
  return make_int4(c.rid[i], c.lo[i], c.hi[i], c.pref[i]);
}

__device__ __forceinline__ void put_row(const Carry& c, int i, int4 v) {
  c.rid[i] = v.x;
  c.lo[i] = v.y;
  c.hi[i] = v.z;
  c.pref[i] = v.w;
}

// an empty slot's row
__device__ __forceinline__ int4 fill_row() { return make_int4(-1, 0, 0, 0); }

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

// Exclusive scan of v over the block's threads; *total gets the block's
// sum. Every thread of the block calls it.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(kAll, w, d);
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

// LF extension of [lo, hi] by base and the marker counts in bwt[0:lo) and
// bwt[0:hi + 1) (markers = i - #dna(< i) - #sentinel(< i))
struct LF {
  int nlo, nhi, mlo, mhi;
};

// (channel base, the sum of the four channels) of occ row r: what
// lf_extend reads of a row (from the packed records, two nibble masks a
// code word)
template <class L>
__device__ __forceinline__ int2 occ_chan_dna(const Index& x, int r, int base) {
  if (x.blocks != nullptr)
    return packed_rank_dev::rank_chan_dna(x.blocks, r, x.n, base);
  const int4 v = occ_row<L>(x, r);
  return make_int2(chan(v, base), v.x + v.y + v.z + v.w);
}

// the LF of [lo, hi1 - 1] from its two rows' (channel base, DNA total) rl
// and rh, with first = sym_start[base]
__device__ __forceinline__ LF lf_of(int lo, int hi1, int2 rl, int2 rh,
                                    int first, int sent) {
  LF out;
  out.nlo = first + rl.x;
  out.nhi = first + rh.x - 1;
  out.mlo = lo - rl.y - (lo > sent ? 1 : 0);
  out.mhi = hi1 - rh.y - (hi1 > sent ? 1 : 0);
  return out;
}

template <class L>
__device__ __forceinline__ LF lf_extend(const Index& x, int lo, int hi,
                                        int base, int sent) {
  const int hi1 = add_wrap(hi, 1);
  const int2 rl = occ_chan_dna<L>(x, lo, base);
  const int2 rh = occ_chan_dna<L>(x, hi1, base);
  const int first = __ldg(x.sym_start + clampi(base, 0, 4));
  return lf_of(lo, hi1, rl, rh, first, sent);
}

// A narrow step's merged extension (scan_steps.build_narrow_step, 3.): a
// single state by its narrow word t (symbol t >> 24; its LF destination or
// jump locus t & 0xFFFFFF), a wide one by its LF w where the wide budget
// covers it (cov; w is zeros where it does not): keep, the kept interval,
// the marker hits and the hit field (the locus of a single state, the
// marker rank of a wide one).
struct Merged {
  bool keep;
  int klo, khi, cnt, hit;
};

__device__ __forceinline__ Merged narrow_merge(bool valid, bool active,
                                               bool single, bool cov,
                                               int base, int t, LF w, int lo,
                                               int hi) {
  const int sym = t >> 24, val = t & 0xFFFFFF;
  const bool ok = single ? sym == base : w.nlo <= w.nhi;
  const bool ac = active && (single || cov);
  Merged m;
  m.keep = (ac && ok) || (valid && !active);
  m.klo = ac ? (single ? val : w.nlo) : lo;
  m.khi = ac ? (single ? val : w.nhi) : hi;
  m.cnt = ac ? (single ? (sym == 5 ? 1 : 0) : w.mhi - w.mlo) : 0;
  m.hit = single ? val : w.mlo;
  return m;
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
      put_row(b, i, fill_row());
    }
  }
  if (__syncthreads_or(dump) && threadIdx.x == 0) ovf[R] = 1;
}

// ---- the blocks' places -----------------------------------------------------
// A block owns the tiles place, place + grid, ... of a step. Placed by
// block index, the busy low tiles of a step with fewer busy tiles than SMs
// can share SMs while others idle (the launch puts consecutive blocks on
// one SM), so a block's place ranks it by (its slot on its SM, its SM):
// places 0 .. (SMs - 1) are on distinct SMs.
constexpr int kMaxSm = kThreads;          // SM ids below it (one a thread)

__device__ __forceinline__ int sm_id() {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  return (int)sm;
}

// The block's slot on its SM, from the (kMaxSm,) counters ``cnt`` zeroed
// behind a grid sync; every thread of the block calls it
__device__ __forceinline__ int sm_slot(int* cnt) {
  __shared__ int slot;
  if (threadIdx.x == 0) {
    const int sm = sm_id();
    if (sm >= kMaxSm) __trap();
    slot = atomicAdd(cnt + sm, 1);
  }
  __syncthreads();
  return slot;
}

// The block's place, once every block's sm_slot is behind a grid sync: the
// blocks in a lower slot on any SM, then those in its slot on a lower SM.
// Every thread of the block calls it.
__device__ __forceinline__ int sm_place(const int* cnt, int slot) {
  const int s = threadIdx.x, c = cnt[s];
  int place;
  block_scan((c < slot ? c : slot) + (s < sm_id() && c > slot ? 1 : 0),
             &place);
  return place;
}

// ---- chained scans with decoupled look-back ------------------------------

constexpr int kLead = (kWarps - 1) * 32;   // the look-back warp's first
                                           // thread
// descriptor states
constexpr int kEmpty = 0, kAggregate = 1, kInclusive = 2;
constexpr int kMaxSpins = 1 << 26;         // waits for one descriptor
// a payload descriptor: the aggregate's 4 fields, then the inclusive
// prefix's, each a word state << 32 | value (so a reader trusts a set of
// four once each word holds its state: one round trip, no ordering)
constexpr int kDescWords = 8;
constexpr int kWordInts = 2;               // ints a count word

using DevWord = cuda::atomic_ref<unsigned long long,
                                 cuda::thread_scope_device>;

// one descriptor word: state << 32 | value
__device__ __forceinline__ void put_word(unsigned long long* w, int state,
                                         int value) {
  DevWord(*w).store(((unsigned long long)state << 32) | (unsigned)value,
                    cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ unsigned long long get_word(
    const unsigned long long* w) {
  return DevWord(*const_cast<unsigned long long*>(w))
      .load(cuda::std::memory_order_relaxed);
}

// A payload: a count (survivors or holes; 0 where unused), the marker
// hits, the last slot with hits (-1: none) and its pref (in tile 0's
// payload without hits: slot 0's, the owner of a step's empty hit records
// when it has no hit at all)
struct Payload {
  int n, sum, last, pref;
};

// the identity
__device__ __forceinline__ Payload no_payload() { return {0, 0, -1, 0}; }

// a then b (b the later tiles), right-biased in last/pref: associative
__device__ __forceinline__ Payload combine(Payload a, Payload b) {
  return b.last >= 0 ? Payload{a.n + b.n, a.sum + b.sum, b.last, b.pref}
                     : Payload{a.n + b.n, a.sum + b.sum, a.last, a.pref};
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

// a count word is one 64-bit word: state << 32 | count (one thread)
__device__ __forceinline__ void publish_count(unsigned long long* d, int state,
                                              int count) {
  put_word(d, state, count);
}

// The counts before tile t > 0 of one step (count words d), by decoupled
// look-back: lane l reads tile end - l of each window of 32, back to the
// nearest inclusive prefix. Called by one whole warp.
__device__ int count_lookback(const unsigned long long* d, int t) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int end = t - 1;; end -= 32) {
    const int j = end - lane;
    unsigned long long w = (unsigned long long)kInclusive << 32;
    if (j >= 0) {
      for (int spins = 0;
           ((w = DevWord(*const_cast<unsigned long long*>(d + j))
                     .load(cuda::std::memory_order_relaxed)) >> 32)
           == kEmpty; ++spins)
        wait(spins);
    }
    const unsigned inc = __ballot_sync(kAll, (w >> 32) == kInclusive);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    excl += warp_sum(lane <= stop ? (int)(unsigned)w : 0);
    if (inc) return excl;
  }
}

// A tile's chained scan over count words d of one step, by the look-back
// warp (every lane calls it): publish the tile's count (tile 0: as its
// inclusive prefix), look back for the exclusive prefix and publish the
// inclusive one. Returns the exclusive prefix.
__device__ __forceinline__ int count_scan(unsigned long long* d, int tile,
                                          int count) {
  if (threadIdx.x == kLead)
    publish_count(d + tile, tile == 0 ? kInclusive : kAggregate, count);
  if (tile == 0) return 0;
  const int e = count_lookback(d, tile);
  if (threadIdx.x == kLead) publish_count(d + tile, kInclusive, e + count);
  return e;
}

// the payload's four words in state ``state`` (one thread)
__device__ __forceinline__ void publish_payload(unsigned long long* d,
                                                int state, Payload v) {
  unsigned long long* f = d + (state == kInclusive ? 4 : 0);
  put_word(f, state, v.n);
  put_word(f + 1, state, v.sum);
  put_word(f + 2, state, v.last);
  put_word(f + 3, state, v.pref);
}

// a tile's inclusive payload, read after the grid sync that ends its step
__device__ __forceinline__ Payload inclusive_payload(
    const unsigned long long* d) {
  return Payload{(int)(unsigned)d[4], (int)(unsigned)d[5],
                 (int)(unsigned)d[6], (int)(unsigned)d[7]};
}

// Tile e's payload as a reader finds it: its inclusive prefix once its four
// words are there, else its aggregate, waiting while neither is whole.
// *inclusive tells which.
__device__ __forceinline__ Payload read_payload(const unsigned long long* e,
                                                bool* inclusive) {
  for (int spins = 0;; ++spins) {
    const unsigned long long a0 = get_word(e), a1 = get_word(e + 1),
                             a2 = get_word(e + 2), a3 = get_word(e + 3),
                             i0 = get_word(e + 4), i1 = get_word(e + 5),
                             i2 = get_word(e + 6), i3 = get_word(e + 7);
    const unsigned long long agg = (unsigned long long)kAggregate << 32,
                             inc = (unsigned long long)kInclusive << 32,
                             hi = ~0ull << 32;
    if (((i0 & hi) == inc) && ((i1 & hi) == inc) && ((i2 & hi) == inc)
        && ((i3 & hi) == inc)) {
      *inclusive = true;
      return Payload{(int)(unsigned)i0, (int)(unsigned)i1, (int)(unsigned)i2,
                     (int)(unsigned)i3};
    }
    if (((a0 & hi) == agg) && ((a1 & hi) == agg) && ((a2 & hi) == agg)
        && ((a3 & hi) == agg)) {
      *inclusive = false;
      return Payload{(int)(unsigned)a0, (int)(unsigned)a1, (int)(unsigned)a2,
                     (int)(unsigned)a3};
    }
    wait(spins);
  }
}

// The payload of the tiles before tile t > 0 of one step (descriptors
// d), by decoupled look-back: lane l reads tile end - l of each window of
// 32, back to the nearest inclusive prefix. Called by one whole warp.
__device__ Payload payload_lookback(const unsigned long long* d, int t) {
  const int lane = threadIdx.x & 31;
  Payload excl = no_payload();
  for (int end = t - 1;; end -= 32) {
    const int j = end - lane;
    bool is_inc = true;
    Payload v = no_payload();
    if (j >= 0) v = read_payload(d + (size_t)kDescWords * j, &is_inc);
    const unsigned inc = __ballot_sync(kAll, is_inc);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    const bool take = lane <= stop;
    const int n = warp_sum(take ? v.n : 0);
    const int sum = warp_sum(take ? v.sum : 0);
    // the nearest tile with a last slot, else the farthest taken one
    const unsigned has = __ballot_sync(kAll, take && v.last >= 0);
    const int src = has ? __ffs(has) - 1 : stop;
    const Payload win = {n, sum, __shfl_sync(kAll, v.last, src),
                         __shfl_sync(kAll, v.pref, src)};
    excl = combine(win, excl);
    if (inc) return excl;
  }
}

// A tile's chained scan over payload descriptors d of one step, by the
// look-back warp (every lane calls it): publish the tile's aggregate
// (tile 0: as its inclusive prefix; tile 0's inclusive prefix must not be
// combined with the identity, which would drop slot 0's pref), then, if
// ``need``, look back and publish the inclusive prefix. Returns the
// exclusive prefix (the identity for tile 0 or without ``need``); *inc
// gets the inclusive one.
__device__ __forceinline__ Payload payload_scan(unsigned long long* d,
                                                int tile, Payload agg,
                                                bool need, Payload* inc) {
  unsigned long long* mine = d + (size_t)kDescWords * tile;
  if (threadIdx.x == kLead)
    publish_payload(mine, tile == 0 ? kInclusive : kAggregate, agg);
  *inc = agg;
  if (tile == 0 || !need) return no_payload();
  const Payload e = payload_lookback(d, tile);
  *inc = combine(e, agg);
  if (threadIdx.x == kLead) publish_payload(mine, kInclusive, *inc);
  return e;
}

// ---- a tile's hit pairs ----------------------------------------------------

// the tile's fields that its hit pairs read
struct PairTile {
  int incl[kThreads];     // inclusive prefix of the marker hits in the tile
  int hit[kThreads];      // hitfield: marker rank (wide) or locus (single)
  int base[kThreads];
  int single[kThreads];
  int pref[kThreads];
  int first[5];           // sym_start
};

// one hit pair of a tile: its owner slot (in the tile), clamped locus,
// outcome, and newborn
struct Pair {
  int s, li, b;
  bool ok;
  int lo, hi;
};

constexpr int kTeam = 4;   // lanes a pair in a tile with few pairs

// The lanes of a tile's pairs: teams of 4 where the pairs fit in one round
// of the block (a team spreads the packed count), else one lane a pair
// (more pairs in flight).
__device__ __forceinline__ int pair_team(int n_pairs) {
  return n_pairs <= kThreads / kTeam ? kTeam : 1;
}

// Channel c of occ row r by a pair's team of ``team`` lanes (1 or 4), the
// same in each: lane v counts code c in code vectors v, v + team, ... of
// r's packed record (packed_rank.cuh: one nibble mask a code word, spread
// over the team); a dense table's row is one load. A c outside 1-4 (a lane
// without a pair) is 0 and loads nothing. Every lane of the warp calls it
// together.
template <class L>
__device__ __forceinline__ int team_chan(const Index& x, int r, int c, int v,
                                         int team) {
  using namespace packed_rank_dev;
  const bool dna = c >= 1 && c <= 4;
  if (x.blocks == nullptr)
    return dna ? chan(occ_row<L>(x, r), c) : 0;
  unsigned n = 0;
  int ck = 0;
  if (dna) {                 // loads not behind the offset: one round trip
    int off;
    const uint4* rec = record_of(x.blocks, r, x.n, &off);
    for (int q = v; q < 4; q += team)
      n += count_vec_code(__ldg(rec + kCodeVec0 + q), off - 32 * q,
                          (unsigned)c);
    ck = ckpt_chan(__ldg(rec), c);
  }
  if (team > 1) {
    n += __shfl_xor_sync(kAll, n, 1);
    n += __shfl_xor_sync(kAll, n, 2);
  }
  return ck + (int)n;
}

// The head of the tile's pair q (its hit q / B, outcome q % B), from the
// tile's shared fields alone: the owner (into r->s, 0 on entry) by a binary
// search over the prefix of hits, its jump locus (direct for a single
// state, marker_rank_locus for a wide one: hit - start_of is the owner's
// own hit index, so the tile's start is not needed), clamped into r->li,
// the outcome into r->b, and both outcome bounds together: *j_lo and
// *j_hi1 = j_hi + 1 where the pair has a locus (else left as they are).
__device__ __forceinline__ void pair_head(const Index& x, const PairTile& ts,
                                          int q, Pair* r, int* j_lo,
                                          int* j_hi1) {
  const int B = x.B;
  const int h = q / B;
  r->b = q - h * B;
#pragma unroll
  for (int half = kThreads / 2; half > 0; half >>= 1)     // incl[s] > h
    if (ts.incl[r->s + half - 1] <= h) r->s += half;
  const int hf = ts.hit[r->s];
  const int own = h - (r->s > 0 ? ts.incl[r->s - 1] : 0);
  const int loc = ts.single[r->s]
      ? hf : __ldg(x.mrl + clampi(add_wrap(hf, own), 0, x.n_mrl - 1));
  r->li = clampi(loc, 0, x.L - 1);
  if (loc >= 0) {
    *j_lo = __ldg(x.out_lo + r->li * B + r->b);
    *j_hi1 = add_wrap(__ldg(x.out_hi + r->li * B + r->b), 1);
  }
}

// The tile's pair q by its team (this lane is v of it): pair_head, and the
// newborn's LF by the owner's base. Every lane of the warp calls it
// together; ``live`` is false for a lane without a pair.
template <class L>
__device__ __forceinline__ Pair tile_pair(const Index& x, const PairTile& ts,
                                          int q, int v, int team, bool live) {
  Pair r = {0, 0, 0, false, 0, 0};
  int j_lo = -1, j_hi1 = 0;
  if (live) pair_head(x, ts, q, &r, &j_lo, &j_hi1);
  const bool rows = j_lo >= 0;
  const int jb = rows ? ts.base[r.s] : 0;
  const int cl = team_chan<L>(x, rows ? j_lo : 0, jb, v, team);
  const int ch = team_chan<L>(x, rows ? j_hi1 : 0, jb, v, team);
  if (rows) {
    const int f = ts.first[clampi(jb, 0, 4)];
    r.lo = f + cl;
    r.hi = f + ch - 1;
    r.ok = r.lo <= r.hi;
  }
  return r;
}

// The first round of a tile's pairs, started before the tile is ranked (a
// pair needs only the tile's own prefix): pair x / team of n_pairs (the
// tile's pairs before the budget cuts them). Every thread of a warp calls
// it together.
template <class L>
__device__ __forceinline__ Pair early_pair(const Index& x, const PairTile& ts,
                                           int n_pairs) {
  const int team = pair_team(n_pairs);
  const int q = threadIdx.x / team;
  return tile_pair<L>(x, ts, q, threadIdx.x % team, team, q < n_pairs);
}

// The tile's pairs q < n_ok, pair q of log record base + q (the tile's
// hits start at base = log_base + start · B): the record (the owner's
// pref, locus · B + outcome) written in place, and a newborn candidate
// (the owner's read ``rid``, its interval, its pref base + q) compacted at
// cand[j], j its rank among the tile's candidates in pair order. ``early``
// holds this thread's pair of the first round, from early_pair with
// n_pairs >= n_ok, for every thread (``early_all``) or for the threads
// below kLead, the look-back warp working its own now. Returns the tile's
// candidates. Every thread of the block calls it.
template <class L>
__device__ int staged_pairs(const Index& x, const PairTile& ts,
                            const int* rid, int n_pairs, int n_ok, int base,
                            Pair early, bool early_all, int* lp, int* le,
                            int4* cand) {
  const int team = pair_team(n_pairs);
  const int per_round = kThreads / team;
  const int v = threadIdx.x % team;
  int n_c = 0;
  for (int q0 = 0; q0 < n_ok; q0 += per_round) {
    const int q = q0 + threadIdx.x / team;
    const bool live = q < n_ok;
    Pair r = early;
    if (q0 > 0 || (!early_all && threadIdx.x >= kLead))
      r = tile_pair<L>(x, ts, q, v, team, live);
    const bool lead = live && v == 0;
    if (lead) {
      lp[base + q] = ts.pref[r.s];
      le[base + q] = r.li * x.B + r.b;
    }
    const bool c = lead && r.ok;
    int round;
    const int j = block_scan(c ? 1 : 0, &round);
    if (c) cand[n_c + j] = make_int4(rid[r.s], r.lo, r.hi, base + q);
    n_c += round;
  }
  return n_c;
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
