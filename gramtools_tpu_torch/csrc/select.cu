// The selection of one scanned buffer on Hopper (sm_90a): from the pool
// states and their replayed paths to each row's fallback bits, its mapped
// flag, the selected states that the per-base recorder walks and the
// sorted loci triples, in two cooperative launches.
//
// Replaces gramtools_tpu/mapping/record_jax.py::select_and_record_device
// (XLA-lowered jnp on the TPU, not Pallas), everything in it but the
// per-base recorder (K9, csrc/walk.cu), which runs between the two
// launches:
//
//   select_kernel   (the function's stages 0-5)
//     0  FB_CHAIN, mapped, the pool part of the state table;
//     1  the encapsulated split: the no-path states' SA occurrences
//        expanded into ecap lanes (_expand_budget), nonvar, each run of
//        equal (state, site, allele) lanes one pseudo-state at its start
//        lane (state N + lane), its hi the SA row of the run's last lane;
//     2  the duplicate-site check of each live state's own path;
//     3  the loci: the traversed loci expanded into lcap lanes and the
//        traversing states' occurrences into trcap lanes (both
//        _expand_budget), A ancestor lanes after each, LT lanes in all;
//        the lanes sorted by (state, site, allele) (a radix sort of a
//        packed key, below); the first of each equal run kept;
//        FB_CONFLICT where two kept neighbours share (state, site);
//     4  a thread a row (a warp where a row has more than kSmallRow live
//        states): each of its live states' key row (its first KCAP
//        distinct base sites, ascending, padded with -1; FB_KCAP past
//        them) from its run of the sorted lanes, the row's classes
//        (class_ord: the distinct key rows below a state's own, by
//        comparing every pair of the row's states) and the pick
//        (libstdc++'s uniform_int first draw, FB_RNG), marking the chosen
//        class's states selected;
//     5  where LT > trip_cap, FB_TRIPS on each row whose selected kept
//        lanes reach past trip_cap in row order (a count a row, kept by
//        the row's thread, and a scan).
//   triples_kernel  (after K9) each lane's row key (the row of a kept
//        lane of a selected state whose row has no fallback bit, R + 1
//        else) and a radix sort of (row key, site, allele) over every
//        lane, cut or padded to trip_cap: the selected triples first, row
//        by row, then the (site, allele)-sorted values of every other
//        lane, invalid lanes included, as the jnp sort leaves them.
//
// Why the outputs are the jnp function's bit for bit. The expansions are
// _expand_budget literally: an int32 (wrapping) inclusive scan of the
// widths, each non-empty item's start lane marked with item + 1 by an
// atomic max, and a prefix max of the marks; so are their clamped
// gathers. Sorted arrays of tuples do not depend on how ties were
// broken, so a radix sort of a key that packs a tuple injectively and in
// order gives the jnp sort's arrays. The kept lanes, the conflicts and
// the key rows are read off the sorted lanes by the jnp rules. A row's
// class_ord and its class count depend only on the set of its states'
// key rows, so the states may sit in a row's bucket in any order. Flags
// go to rows by atomicOr and counts by atomicAdd, both independent of
// order. Every masked write of the jnp code that XLA drops writes
// nothing here.
//
// What bounds it on this card: latency and grid-wide barriers, not bytes
// (a buffer moves ~10 MB, 3 us at 3.35 TB/s). So the design counts its
// grid syncs. Every scan (the expansions' widths, their marks' prefix
// max, the encapsulated runs' starts, the row counts, the selected-lane
// counts) is a chained scan over tiles of 256 items with decoupled
// look-back (Merrill and Garland, 2016; descriptor words of
// scan_common.cuh, state beside value): no grid sync inside it. Grid
// syncs stand only where a phase reads what any block may have written:
// the zeroed accumulators, the marks (an atomic max from any item), the
// state table, the lanes, the key bits and each sort pass's output.
//
// The radix sorts: keys (primary << L) | (site - site_min) << ab |
// (allele - allele_min), where sb and ab are the bits of the site and
// allele ranges over the lanes (a min/max reduction in the launch) and L
// is sb + ab rounded up to whole 8-bit digits, so the passes are as many
// as the data needs: a 20,000-read buffer (R = 30,720 rows, NS = 43,008
// states) on a graph of 100,000 biallelic sites (site markers below 2^18,
// alleles -1..1) packs 16 + 24 bits for the dedup sort and 15 + 24 for the
// triple sort. The key is a uint64_t where the host's bound on that width
// (ops/select.py::key_bits: from the shapes, the states, the rows, the
// sites and the graph's nodes) is at most 64, an unsigned __int128
// otherwise; the C entry point takes the instance as an argument. A 64-bit
// instance given lanes whose exact width passes 64 (sites or alleles
// outside the graph's tables) traps: a launch error, never a wrong sort.
// Each sort is a one-sweep LSD sort of 8-bit digits (Adinets and Merrill,
// "Onesweep", 2022): one sweep builds every digit's histogram (a grid
// sync), then each pass reads its tile once, ranks its keys by warp
// multisplit (__match_any_sync and a digit counter a warp in shared
// memory), finds each digit's offset over the tiles before it by a
// chained scan of per-tile, per-digit descriptors (one thread a digit
// looks back, 4 tiles at a time) and scatters: one grid sync a pass. A pass whose digit is
// the same for every key is skipped. Tiles are 256 threads of 1-8 keys,
// as many as spread the keys over the grid, so that every co-resident
// block has a tile. The dedup sort's passes over the fields leave the
// lanes in (site, allele) order in a buffer that its later passes, over
// the state, do not overwrite; those carry each key's place in that order
// beside it, so each kept flag also lands at its lane's place there. The
// triple sort starts from that order, each lane's state replaced by its
// row key, and runs the row key's passes only: sorted tuples do not
// depend on how ties were broken, so this is the sort of every lane's
// (row key, site, allele). 40 bits take 5 passes, the row key's 15 bits
// 2.
//
// A launch is a cooperative grid (the blocks co-resident on the card, at
// most kBlocksPerSm an SM); its blocks take their tiles of each scan and
// sort pass in increasing order, so the least tile not done waits on
// finished tiles only. Grid syncs: 7 + the dedup sort's passes in the
// first launch (12 at 5 passes), 1 + the row key's passes in the second
// (3 at 2). ``stage`` (GRAMTOOLS_TPU_RECORD_STAGE) stops the first
// launch after the numbered block, as the jnp code returns there.
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers, its scratch and PyTorch's current stream; the launch
// functions return the launch's cudaError_t, 0 on success. A build with
// -DK8_SYNCS counts each launch's grid syncs and sort passes and stamps
// block 0's time at each sync and each sort pass's first and last tiles'
// at each stage (select_syncs), for the smoke; the path's build counts
// nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 256;                  // 8-bit digits
constexpr int kMaxItems = 8;                 // keys a thread in a sort tile
constexpr int kMaxPasses = 12;               // 8-bit digits of 95 bits
constexpr int kRowTile = kThreads;           // rows a stage-4 tile
constexpr int kSmallRow = 4;                 // live states a row that one
                                             // thread ranks; a warp more
constexpr int kTcap = 16;                    // search_log_host.TCAP
constexpr int kMaxKcap = 12;                 // search_log_host.KCAP
constexpr int kBlocksPerSm = 2;
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xFFFFFFFFu;

static_assert(kThreads == kRadix, "a thread a digit");

// search_log_host.FB_*
constexpr int kFbChain = 1, kFbEnc = 2, kFbDupSite = 4, kFbTrav = 8,
              kFbKcap = 16, kFbConflict = 32, kFbRng = 64, kFbTrips = 128,
              kFbLoci = 1024;

typedef unsigned __int128 u128;
typedef unsigned long long Word;             // a descriptor word

// meta words
enum { kSiteMin, kSiteMax, kAlleleMin, kAlleleMax, kTotalE, kTotalL,
       kTotalT, kMid, kMeta = 16 };
// the chained scans' descriptor arrays, a word a tile each
enum { kDescE, kDescEm, kDescRun, kDescL, kDescT, kDescRows, kDescLm,
       kDescTm, kDescTrips, kDescs };

// keys a thread in a sort tile: as many as spread n keys over the grid
__host__ __device__ inline int sort_items(long long n, int grid) {
  const long long per = (n + (long long)grid * kThreads - 1)
                        / ((long long)grid * kThreads);
  return per < 1 ? 1 : (per > kMaxItems ? kMaxItems : (int)per);
}

__host__ __device__ inline long long tiles_of(long long n, long long per) {
  return (n + per - 1) / per;
}

struct Params {
  // pool states (N)
  int N;
  const int* f_rid;
  const int* f_lo;
  const int* f_hi;
  const int2* trav;                 // (N, kTcap)
  const int* n_trav;
  const int2* ing;                  // (N, kTcap)
  const int* n_ing;
  const unsigned char* state_bad;
  // rows (R)
  int R;
  const unsigned char* row_ok;
  const long long* row_first_raw;
  // tables
  const int* sa;
  int sa_size;
  const int* ra_node;
  int n_ra;
  const int* nt_site;
  const int* nt_allele;
  const int* anc_len;               // (n_sites,)
  const int* anc_site;              // (n_sites, anc_stride)
  const int* anc_allele;
  const int* base_site;             // (n_sites,)
  int n_sites;
  int anc_stride;
  int A;
  // budgets
  int ecap, lcap, trcap, kcap, trip_cap, check_trips, stage;
  // outputs of the first launch
  int* fallback;
  unsigned char* mapped;
  int* ps_row;
  int* ps_lo;
  int* ps_hi;
  int2* ps_trav;                    // (NS, kTcap)
  int* ps_ntrav;
  unsigned char* st_selected;
  // the second launch: the fallback after K9, the triples
  const int* fb_final;
  int* t_row;
  int* t_site;
  int* t_allele;
  // scratch
  int* ps_ning;
  int* ing_parent;
  unsigned char* ps_live;
  int* cum_e;
  int* e_marks;
  int* nonvar;
  int* cum_l;
  int* cum_t;
  int* l_marks;
  int* t_marks;
  int* lane_key;
  int* lane_site;
  int* lane_allele;
  void* keys_a;                     // (LT,) keys of the instance's type
  void* keys_b;
  void* keys_c;
  unsigned* vals_a;                 // (LT,) each key's place in the
  unsigned* vals_b;                 // field order
  unsigned char* keep;
  unsigned char* keep_mid;          // keep, at each key's place in the
                                    // field order
  int* hist;                        // (2, kMaxPasses, kRadix)
  int* seg_start;
  int* seg_end;
  int* key_mat;                     // (NS, kcap)
  int* row_cnt;
  int* row_off;
  int* row_cur;
  int* bucket;
  unsigned char* first_occ;
  Word* desc[kDescs];               // the scans' descriptors
  Word* sort_desc;                  // (sort tiles, kRadix), every pass
  int n_desc;                       // words in desc[0..kDescs) together
  int sort_tiles;
  int* meta;
};

#ifdef K8_SYNCS
// [0] the first launch's grid syncs, [1] the second's, [2] and [3] their
// sort passes run; block 0's thread 0 counts, zeroing at its launch's
// start. g_k8_t[launch]: the global timer (ns) at block 0's start, at the
// end of each of its grid syncs and at its end. g_k8_p[launch][pass]
// [tile 0, tile T - 1]: the timer at the tile's start, its keys ranked,
// its digits' look-back done and its keys scattered.
constexpr int kK8Stamps = 32;
__device__ unsigned long long g_k8[4];
__device__ unsigned long long g_k8_t[2][kK8Stamps];
__device__ unsigned long long g_k8_p[2][kMaxPasses][2][4];
#endif

__device__ __forceinline__ void count_k8(int which) {
#ifdef K8_SYNCS
  if (blockIdx.x == 0 && threadIdx.x == 0) ++g_k8[which];
#endif
}

// block 0's stamp ``at`` syncs past its launch's last one (0: after it)
__device__ __forceinline__ void stamp_k8(int launch, int at) {
#ifdef K8_SYNCS
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const unsigned long long k = g_k8[launch] + at;
    if (k < kK8Stamps) g_k8_t[launch][k] = scan_dev::global_timer();
  }
#endif
}

// the sort pass's stamp k of tile t of T (g_k8_p), by the tile's thread 0
__device__ __forceinline__ void stamp_pass(int slot, int t, int T, int k) {
#ifdef K8_SYNCS
  if (threadIdx.x == 0 && (t == 0 || t == T - 1) && slot >= 0)
    g_k8_p[slot / kMaxPasses][slot % kMaxPasses][t == 0 ? 0 : 1][k] =
        scan_dev::global_timer();
#endif
}

__device__ __forceinline__ void grid_sync(cg::grid_group& grid, int launch) {
  count_k8(launch);
  grid.sync();
  stamp_k8(launch, 0);
}

struct Sums {
  __device__ static int id() { return 0; }
  __device__ static int f(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);      // int32 wrap, as jnp
  }
};

struct Maxes {
  __device__ static int id() { return INT_MIN; }
  __device__ static int f(int a, int b) { return a > b ? a : b; }
};

struct Mins {
  __device__ static int id() { return INT_MAX; }
  __device__ static int f(int a, int b) { return a < b ? a : b; }
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int bits_of(unsigned x) {
  return x ? 32 - __clz((int)x) : 0;
}

// floor((site - 5) / 2) clamped to a site index, as jnp's sidx
__device__ __forceinline__ int site_index(int site, int n_sites) {
  return clampi(add_wrap(site, -5) >> 1, 0, n_sites - 1);
}

template <class Op>
__device__ __forceinline__ int warp_reduce(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = Op::f(v, __shfl_xor_sync(kAll, v, d));
  return v;
}

// the block's shared words of the reductions and the chained scans
struct ScanSmem {
  int ws[kWarps];
  int excl;
};

// Op over the block's values; every thread gets it
template <class Op>
__device__ int block_reduce(int v, ScanSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_reduce<Op>(v);
  if (lane == 0) sm.ws[warp] = v;
  __syncthreads();
  int r = Op::id();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r = Op::f(r, sm.ws[w]);
  __syncthreads();
  return r;
}

// inclusive Op-scan over the block's threads; *total: the block's fold
template <class Op>
__device__ int block_scan(int v, ScanSmem& sm, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x = Op::f(y, x);
  }
  if (lane == 31) sm.ws[warp] = x;
  __syncthreads();
  int before = Op::id(), all = Op::id();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = Op::f(before, sm.ws[w]);
    all = Op::f(all, sm.ws[w]);
  }
  __syncthreads();
  *total = all;
  return Op::f(before, x);
}

// ---------------------------------------------------------------------------
// chained scans with decoupled look-back (descriptor words of
// scan_common.cuh: state << 32 | value)
// ---------------------------------------------------------------------------

// The Op-fold of the tiles before tile t > 0 (descriptors d), by decoupled
// look-back: lane l reads tile end - l of each window of 32, back to the
// nearest inclusive prefix. Called by one whole warp; Op commutes.
template <class Op>
__device__ int lookback(const Word* d, int t) {
  const int lane = threadIdx.x & 31;
  int excl = Op::id();
  for (int end = t - 1;; end -= 32) {
    const int j = end - lane;
    Word w = ((Word)scan_dev::kInclusive << 32) | (unsigned)Op::id();
    if (j >= 0) {
      for (int spins = 0; ((w = scan_dev::get_word(d + j)) >> 32)
                          == (Word)scan_dev::kEmpty; ++spins)
        scan_dev::wait(spins);
    }
    const unsigned inc = __ballot_sync(
        kAll, (w >> 32) == (Word)scan_dev::kInclusive);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    excl = Op::f(excl, warp_reduce<Op>(lane <= stop ? (int)(unsigned)w
                                                    : Op::id()));
    if (inc) return excl;
  }
}

// Tile ``tile``'s step of a chained Op-scan over descriptors d, one value a
// thread (Op::id() where there is none): publishes the tile's fold (tile
// 0: as its inclusive prefix), looks back by warp 0 and publishes the
// inclusive prefix. Returns the thread's inclusive prefix over every tile
// so far; *excl gets the tiles' before this one. Every thread calls it.
template <class Op>
__device__ int tile_scan(int v, Word* d, int tile, ScanSmem& sm,
                         int* excl = nullptr) {
  int total;
  const int incl = block_scan<Op>(v, sm, &total);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      scan_dev::put_word(d + tile, tile == 0 ? scan_dev::kInclusive
                                             : scan_dev::kAggregate, total);
    int e = Op::id();
    if (tile > 0) {
      e = lookback<Op>(d, tile);
      if (threadIdx.x == 0)
        scan_dev::put_word(d + tile, scan_dev::kInclusive, Op::f(e, total));
    }
    if (threadIdx.x == 0) sm.excl = e;
  }
  __syncthreads();
  const int e = sm.excl;
  __syncthreads();
  if (excl) *excl = e;
  return Op::f(e, incl);
}

// ---------------------------------------------------------------------------
// the one-sweep radix sort
// ---------------------------------------------------------------------------

struct SortSmem {
  int wcnt[kWarps][kRadix];   // a digit counter a warp; then each warp's
                              // first place of each digit
  int gbase[kRadix];          // the digits' first places over all tiles
};

struct HistSmem {
  int h[kMaxPasses][kRadix];
};

template <class K>
__device__ __forceinline__ int digit(K k, int shift) {
  return (int)(k >> shift) & (kRadix - 1);
}

// a sort pass's descriptor word: (tag << 1 | inclusive) << 32 | count, the
// tag the pass's own (1, 2, ...), so one array serves every pass; a word
// of an earlier pass reads as empty
__device__ __forceinline__ void put_count(Word* w, int tag, bool inc,
                                          int count) {
  scan_dev::put_word(w, (tag << 1) | (inc ? 1 : 0), count);
}

// tiles a digit's look-back reads at once: 4 beat 1, 2, 8 and 16 by events
// on the smoke's buffer (PERF.md); 8 spills the 128-bit instance
constexpr int kWindow = 4;

// digit d's keys in the tiles before tile t > 0 of the pass tagged
// ``tag``: one thread looks back kWindow tiles at a time (their loads in
// flight together), to the nearest inclusive count
__device__ __forceinline__ int digit_lookback(const Word* desc, int t, int d,
                                              int tag) {
  int excl = 0;
  for (int end = t - 1;; end -= kWindow) {
    Word w[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i)
      if (end - i >= 0)
        w[i] = scan_dev::get_word(desc + (size_t)(end - i) * kRadix + d);
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      // tile 0 is inclusive, so the look-back stops at it at the latest
      const Word* at = desc + (size_t)(end - i) * kRadix + d;
      for (int spins = 0; (int)(w[i] >> 33) != tag; ++spins) {
        scan_dev::wait(spins);
        w[i] = scan_dev::get_word(at);
      }
      excl += (int)(unsigned)w[i];
      if ((w[i] >> 32) & 1) return excl;
    }
  }
}

// Adds the digit counts of passes [pass0, passes) of the keys key(0), ...,
// key(n - 1)
// (grid-strided; ``key`` may write its key where the sort reads it) to
// hist (kMaxPasses rows of kRadix, zeroed behind a grid sync). Every
// thread calls it.
template <class K, class F>
__device__ void sort_histogram(int n, int pass0, int passes, int* hist,
                               HistSmem& s, F key) {
  for (int i = threadIdx.x; i < passes * kRadix; i += kThreads)
    (&s.h[0][0])[i] = 0;
  __syncthreads();
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < n;
       q += gridDim.x * kThreads) {
    const K k = key(q);
    for (int pass = pass0; pass < passes; ++pass)
      atomicAdd(&s.h[pass][digit(k, 8 * pass)], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kRadix; i += kThreads) {
    const int c = (&s.h[0][0])[i];
    if (c) atomicAdd(hist + i, c);
  }
}

// One stable pass by digit (k >> shift) & 255 from src to dst, tiles of
// kThreads * items keys; hist: the pass's kRadix digit counts. With
// kVals, each key's value (sv[i], or i where sv is null) goes with it
// from sv to dv.
template <class K, bool kVals>
__device__ void sort_pass(const K* src, K* dst, const unsigned* sv,
                          unsigned* dv, int n, int shift, int items,
                          const int* hist, Word* desc, int tag, SortSmem& s,
                          ScanSmem& sm, int slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1;
  {
    const int v = hist[threadIdx.x];
    int total;
    s.gbase[threadIdx.x] = block_scan<Sums>(v, sm, &total) - v;
  }
  const int per = kThreads * items;
  const int T = (int)tiles_of(n, per);
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    stamp_pass(slot, t, T, 0);
    for (int d = lane; d < kRadix; d += 32) s.wcnt[warp][d] = 0;
    // a warp's keys are consecutive, item j of lane l the (j * 32 + l)-th
    const int first = t * per + warp * 32 * items + lane;
    K key[kMaxItems];
    unsigned val[kMaxItems];
    int dig[kMaxItems], rank[kMaxItems];
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      const int i = first + j * 32;
      if (j < items && i < n) {
        key[j] = src[i];
        if (kVals) val[j] = sv ? sv[i] : (unsigned)i;
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      if (j >= items) break;
      const bool valid = first + j * 32 < n;
      // an invalid lane's digit matches no other lane's
      const int d = valid ? digit(key[j], shift) : kRadix + lane;
      dig[j] = d;
      const unsigned peers = __match_any_sync(kAll, d);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (valid && lane == leader) {
        before = s.wcnt[warp][d];
        s.wcnt[warp][d] = before + __popc(peers);
      }
      rank[j] = __shfl_sync(kAll, before, leader) + __popc(peers & lower);
      __syncwarp();
    }
    __syncthreads();
    stamp_pass(slot, t, T, 1);
    // thread d: the tile's keys of digit d, and each warp's first among them
    const int d = threadIdx.x;
    int cnt = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s.wcnt[w][d];
      s.wcnt[w][d] = cnt;
      cnt += c;
    }
    Word* mine = desc + (size_t)t * kRadix + d;
    int excl = 0;
    if (t == 0) {
      put_count(mine, tag, true, cnt);
    } else {
      put_count(mine, tag, false, cnt);
      excl = digit_lookback(desc, t, d, tag);
      put_count(mine, tag, true, excl + cnt);
    }
    const int at = s.gbase[d] + excl;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s.wcnt[w][d] += at;
    __syncthreads();
    stamp_pass(slot, t, T, 2);
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j)
      if (j < items && first + j * 32 < n) {
        const int at = s.wcnt[warp][dig[j]] + rank[j];
        dst[at] = key[j];
        if (kVals) dv[at] = val[j];
      }
    __syncthreads();
    stamp_pass(slot, t, T, 3);
  }
}

// Pass ``pass`` of an LSD sort (digit 8 * pass, tagged tag0 + pass) from
// src to dst, with values where kVals, unless its digit is one value for
// every key (a pass that moves nothing); hist: every pass's digit counts
// (sort_histogram, behind a grid sync). True where it ran and the grid
// sync after it. Every block calls it alike.
template <class K, bool kVals>
__device__ bool sort_step(cg::grid_group& grid, int launch, const K* src,
                          K* dst, const unsigned* sv, unsigned* dv, int n,
                          int pass, const int* hist, Word* desc, int tag0,
                          SortSmem& s, ScanSmem& sm) {
  if (__syncthreads_or(hist[pass * kRadix + threadIdx.x] == n)) return false;
  sort_pass<K, kVals>(src, dst, sv, dv, n, 8 * pass, sort_items(n, gridDim.x),
                      hist + pass * kRadix, desc, tag0 + pass, s, sm,
                      launch * kMaxPasses + pass);
  count_k8(2 + launch);
  grid_sync(grid, launch);
  return true;
}

// the packing of (site, allele) under a primary key, the fields' bits
// rounded up to whole digits (so an LSD sort's passes over the fields end
// where the primary key's begin)
template <class K>
struct Packing {
  int smin, amin, sb, ab;
  __device__ int low() const { return (sb + ab + 7) & ~7; }
  __device__ K pack(unsigned primary, int site, int allele) const {
    return ((K)primary << low())
        | ((K)((unsigned)site - (unsigned)smin) << ab)
        | (K)((unsigned)allele - (unsigned)amin);
  }
  __device__ int primary(K k) const { return (int)(k >> low()); }
  __device__ int site(K k) const {
    const unsigned f = (unsigned)((k >> ab) & (((K)1 << sb) - 1));
    return (int)(f + (unsigned)smin);
  }
  __device__ int allele(K k) const {
    const unsigned f = (unsigned)(k & (((K)1 << ab) - 1));
    return (int)(f + (unsigned)amin);
  }
  __device__ K fields(K k) const { return k & (((K)1 << low()) - 1); }
};

template <class K>
__device__ Packing<K> packing(const int* meta) {
  Packing<K> p;
  p.smin = meta[kSiteMin];
  p.amin = meta[kAlleleMin];
  p.sb = bits_of((unsigned)meta[kSiteMax] - (unsigned)meta[kSiteMin]);
  p.ab = bits_of((unsigned)meta[kAlleleMax] - (unsigned)meta[kAlleleMin]);
  return p;
}

// lexicographic compare of two key rows (signed ints)
__device__ __forceinline__ int key_cmp(const int* a, const int* b, int kcap) {
  for (int c = 0; c < kcap; ++c)
    if (a[c] != b[c]) return a[c] < b[c] ? -1 : 1;
  return 0;
}

// the widths of the three expansions
__device__ __forceinline__ int enc_width(const Params& p, int i) {
  const int rid = p.f_rid[i];
  const bool alive = rid >= 0 && p.row_ok[clampi(rid, 0, p.R - 1)];
  const bool has_path = p.n_trav[i] > 0 || p.n_ing[i] > 0;
  return alive && !has_path ? add_wrap(add_wrap(p.f_hi[i], -p.f_lo[i]), 1)
                            : 0;
}

__device__ __forceinline__ int loci_width(const Params& p, int s) {
  return p.ps_live[s] ? p.ps_ntrav[s] : 0;
}

__device__ __forceinline__ int trav_width(const Params& p, int s) {
  return p.ps_live[s] && p.ps_ning[s] > 0
             ? add_wrap(add_wrap(p.ps_hi[s], -p.ps_lo[s]), 1) : 0;
}

// an _expand_budget scan's emit: cum, the run-start mark, the spill flag
__device__ __forceinline__ void expand_emit(int i, int cum, int w, int cap,
                                            int* cum_out, int* marks,
                                            int* fallback, int row, int bit) {
  cum_out[i] = cum;
  const int start = add_wrap(cum, -w);
  if (w > 0 && start < cap) atomicMax(marks + clampi(start, 0, cap - 1), i + 1);
  if (w > 0 && cum > cap) atomicOr(fallback + row, bit);
}

// One _expand_budget width scan over n items, a tile of kThreads a step:
// cum, marks, spill flags (row(i), bit), the total at meta[total].
template <class W, class Row>
__device__ void width_scan(const Params& p, int n, W width, Row row, int cap,
                           int* cum_out, int* marks, int bit, Word* desc,
                           int total, ScanSmem& sm) {
  const int T = (int)tiles_of(n, kThreads);
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const int i = t * kThreads + threadIdx.x;
    const int w = i < n ? width(i) : 0;
    const int cum = tile_scan<Sums>(w, desc, t, sm);
    if (i < n) {
      expand_emit(i, cum, w, cap, cum_out, marks, p.fallback, row(i), bit);
      if (i == n - 1) p.meta[total] = cum;
    }
  }
}

// A marks prefix-max scan over cap lanes: emit(g, mark) for each lane.
template <class E>
__device__ void marks_scan(int cap, const int* marks, Word* desc,
                           ScanSmem& sm, E emit) {
  const int T = (int)tiles_of(cap, kThreads);
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const int g = t * kThreads + threadIdx.x;
    const int mark = tile_scan<Maxes>(g < cap ? marks[g] : Maxes::id(), desc,
                                      t, sm);
    if (g < cap) emit(g, mark);
  }
}

// a duplicate site in state s's own path (traversed and traversing sites,
// the unused slots padded with distinct values 2^28 + slot, as jnp's)
__device__ bool dup_site(const Params& p, int s) {
  const int nt = min(max(p.ps_ntrav[s], 0), kTcap);
  const int ni = min(max(p.ps_ning[s], 0), kTcap);
  int v[2 * kTcap];
  int n = 0;
  for (int k = 0; k < nt; ++k) v[n++] = p.ps_trav[s * kTcap + k].x;
  for (int k = 0; k < ni; ++k) v[n++] = p.ing[s * kTcap + k].x;
  for (int a = 0; a < n; ++a) {
    for (int b = a + 1; b < n; ++b)
      if (v[a] == v[b]) return true;
    // a real site equal to an unused slot's pad value
    const long long t = (long long)v[a] - (1 << 28);
    if (t >= nt && t < kTcap) return true;
    if (t - kTcap >= ni && t - kTcap < kTcap) return true;
  }
  return false;
}

// one encapsulated lane: its item, SA row, site, allele, validity
struct EncLane {
  int item[kThreads + 2];
  int occ[kThreads + 2];
  int site[kThreads + 2];
  int allele[kThreads + 2];
  unsigned char valid[kThreads + 2];
};

// lane g of the encapsulated split, given its marks' prefix max, into slot
// k of the tile's lanes
__device__ __forceinline__ void enc_lane(const Params& p, int g, int mark,
                                         EncLane& L, int k) {
  const int item = clampi(mark - 1, 0, p.N - 1);
  const int start = add_wrap(p.cum_e[item], -enc_width(p, item));
  const int off = add_wrap(g, -start);
  const bool valid = g < min(p.meta[kTotalE], p.ecap);
  const int occ = clampi(add_wrap(p.f_lo[item], off), 0, p.sa_size - 1);
  const int node = p.ra_node[clampi(p.sa[occ], 0, p.n_ra - 1)];
  L.item[k] = item;
  L.occ[k] = occ;
  L.site[k] = valid ? p.nt_site[node] : 0;
  L.allele[k] = p.nt_allele[node];
  L.valid[k] = valid;
}

union PhaseSmem {
  EncLane lane;
  SortSmem sort;
  HistSmem hist;
  struct {
    int nsel[kRowTile];       // each row's stage-5 count
    int big[kRowTile];        // the tile's rows left to warps
    int n_big;
  } rows;
};

// State s's key row (its first kcap distinct base sites over its kept
// lanes, ascending, padded with -1) into key_mat, by one warp; true where
// it has more (FB_KCAP).
template <class K>
__device__ bool key_row(const Params& p, const K* keys, const Packing<K>& pk,
                        int s) {
  const int lane = threadIdx.x & 31, kcap = p.kcap;
  const int a = p.seg_start[s], b = p.seg_end[s];
  long long prev = LLONG_MIN;
  int c = 0;
  bool over = false;
  for (;;) {
    long long best = LLONG_MAX;
    for (int q = a + lane; q < b; q += 32) {
      if (!p.keep[q]) continue;
      const int base = p.base_site[site_index(pk.site(keys[q]), p.n_sites)];
      if (base > prev && base < best) best = base;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long o = __shfl_xor_sync(kAll, best, d);
      best = o < best ? o : best;
    }
    if (best == LLONG_MAX) break;
    if (c == kcap) {
      over = true;
      break;
    }
    if (lane == 0) p.key_mat[(size_t)s * kcap + c] = (int)best;
    ++c;
    prev = best;
  }
  for (int q = c + lane; q < kcap; q += 32)
    p.key_mat[(size_t)s * kcap + q] = -1;
  return over;
}

// Row r's stage 4 by one warp: its states' key rows, classes and pick;
// returns the row's selected kept lanes where its fallback stays 0 (the
// stage-5 count), else 0.
template <class K>
__device__ int row_pick(const Params& p, const K* keys, const Packing<K>& pk,
                        int r) {
  const int lane = threadIdx.x & 31, kcap = p.kcap;
  const int k = p.row_cnt[r];
  if (k == 0) return 0;
  const int* st = p.bucket + p.row_off[r];
  bool over = false;
  for (int i = 0; i < k; ++i) over |= key_row(p, keys, pk, st[i]);
  __syncwarp();
  // the row's bits of the stages before (behind a grid sync) and its own
  int fb = p.fallback[r];
  if (over) {
    fb |= kFbKcap;
    if (lane == 0) atomicOr(p.fallback + r, kFbKcap);
  }
  unsigned char* first = p.first_occ + p.row_off[r];
  auto key = [&](int i) { return p.key_mat + (size_t)st[i] * kcap; };
  int n_first = 0;
  for (int i = lane; i < k; i += 32) {
    bool f = true;
    for (int j = 0; j < i && f; ++j) f = key_cmp(key(j), key(i), kcap) != 0;
    first[i] = f;
    n_first += f;
  }
  __syncwarp();
  const int n_classes = warp_reduce<Sums>(n_first);
  // the pick: libstdc++'s uniform_int first draw, in 64-bit
  const int nv = p.nonvar[r];
  const int total = add_wrap(nv, n_classes);
  const bool active = n_classes > 0;
  const long long totals = total < 1 ? 1 : total;
  const long long scaling = 0xFFFFFFFFLL / totals;
  const long long rdraw = p.row_first_raw[r] & 0xFFFFFFFFLL;
  if (active && rdraw >= totals * scaling) {
    fb |= kFbRng;
    if (lane == 0) atomicOr(p.fallback + r, kFbRng);
  }
  const int selected = add_wrap(1, (int)(rdraw / (scaling < 1 ? 1 : scaling)));
  const int chosen = add_wrap(add_wrap(selected, -nv), -1);
  const bool record = active && chosen >= 0 && chosen < n_classes;
  unsigned mine = 0;              // bit i / 32 of lane i % 32: state i chosen
  for (int i = lane; i < k && record; i += 32) {
    int ord = 0;
    for (int j = 0; j < k; ++j)
      ord += first[j] && key_cmp(key(j), key(i), kcap) < 0;
    if (ord == chosen) {
      p.st_selected[st[i]] = 1;
      if (i < 32 * 32) mine |= 1u << (i >> 5);
    }
  }
  __syncwarp();
  if (!record || fb != 0) return 0;
  // the kept lanes of the chosen states (stage 5's count of the row)
  int n = 0;
  for (int i = 0; i < k; ++i) {
    const bool chosen_i =
        i < 32 * 32 ? (__shfl_sync(kAll, mine, i & 31) >> (i >> 5)) & 1
                    : p.st_selected[st[i]];
    if (!chosen_i) continue;
    const int s = st[i];
    for (int q = p.seg_start[s] + lane; q < p.seg_end[s]; q += 32)
      n += p.keep[q];
  }
  return warp_reduce<Sums>(n);
}

// State s's key row as key_row's, by one thread: the kcap + 1 smallest
// distinct base sites of its kept lanes kept in order, its lanes read
// eight at a time (their loads in flight together).
template <class K>
__device__ bool key_row_thread(const Params& p, const K* keys,
                               const Packing<K>& pk, int s) {
  const int kcap = p.kcap;
  const int a = p.seg_start[s], b = p.seg_end[s];
  int row[kMaxKcap + 1];
  int c = 0;
  for (int q0 = a; q0 < b; q0 += 8) {
    int v[8];
    unsigned valid = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = q0 + j;
      v[j] = 0;
      if (q < b && p.keep[q]) {
        v[j] = site_index(pk.site(keys[q]), p.n_sites);
        valid |= 1u << j;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (valid >> j & 1) v[j] = p.base_site[v[j]];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!(valid >> j & 1)) continue;
      int at = 0;
      while (at < c && row[at] < v[j]) ++at;
      if ((at < c && row[at] == v[j]) || at > kcap) continue;
      for (int m = c < kcap + 1 ? c : kcap; m > at; --m) row[m] = row[m - 1];
      row[at] = v[j];
      if (c < kcap + 1) ++c;
    }
  }
  for (int m = 0; m < kcap; ++m)
    p.key_mat[(size_t)s * kcap + m] = m < c ? row[m] : -1;
  return c > kcap;
}

// Row r's stage 4 as row_pick's, by one thread, for a row of 1 to
// kSmallRow live states.
template <class K>
__device__ int row_pick_thread(const Params& p, const K* keys,
                               const Packing<K>& pk, int r, int k) {
  const int kcap = p.kcap;
  const int* st = p.bucket + p.row_off[r];
  bool over = false;
  for (int i = 0; i < k; ++i) over |= key_row_thread(p, keys, pk, st[i]);
  int fb = p.fallback[r];
  if (over) {
    fb |= kFbKcap;
    atomicOr(p.fallback + r, kFbKcap);
  }
  auto key = [&](int i) { return p.key_mat + (size_t)st[i] * kcap; };
  unsigned first = 0;
  int n_classes = 0;
  for (int i = 0; i < k; ++i) {
    bool f = true;
    for (int j = 0; j < i && f; ++j) f = key_cmp(key(j), key(i), kcap) != 0;
    if (f) {
      first |= 1u << i;
      ++n_classes;
    }
  }
  // the pick: libstdc++'s uniform_int first draw, in 64-bit
  const int nv = p.nonvar[r];
  const int total = add_wrap(nv, n_classes);
  const long long totals = total < 1 ? 1 : total;
  const long long scaling = 0xFFFFFFFFLL / totals;
  const long long rdraw = p.row_first_raw[r] & 0xFFFFFFFFLL;
  if (rdraw >= totals * scaling) {          // n_classes > 0 here
    fb |= kFbRng;
    atomicOr(p.fallback + r, kFbRng);
  }
  const int selected = add_wrap(1, (int)(rdraw / (scaling < 1 ? 1 : scaling)));
  const int chosen = add_wrap(add_wrap(selected, -nv), -1);
  if (chosen < 0 || chosen >= n_classes) return 0;
  int n = 0;
  for (int i = 0; i < k; ++i) {
    int ord = 0;
    for (int j = 0; j < k; ++j)
      ord += (first >> j & 1) && key_cmp(key(j), key(i), kcap) < 0;
    if (ord != chosen) continue;
    const int s = st[i];
    p.st_selected[s] = 1;
    if (fb == 0)
      for (int q = p.seg_start[s]; q < p.seg_end[s]; ++q) n += p.keep[q];
  }
  return fb == 0 ? n : 0;
}

// ---------------------------------------------------------------------------
// the first launch: stages 0-5
// ---------------------------------------------------------------------------

template <class K>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
select_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ ScanSmem sm;
  __shared__ PhaseSmem ph;
  const int N = p.N, R = p.R, NS = p.N + p.ecap, G = gridDim.x;
  const int NB = p.lcap + p.trcap, LT = NB * (p.A + 1);
  const int gt = blockIdx.x * kThreads + threadIdx.x, gs = G * kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  K* keys_a = static_cast<K*>(p.keys_a);
  K* keys_b = static_cast<K*>(p.keys_b);

#ifdef K8_SYNCS
  if (gt == 0) g_k8[0] = g_k8[2] = 0;
#endif
  stamp_k8(0, 0);
  // ---- zero the accumulators and the descriptors ----
  for (int r = gt; r < R; r += gs) {
    p.fallback[r] = 0;
    p.mapped[r] = 0;
    p.nonvar[r] = 0;
    p.row_cnt[r] = 0;
  }
  for (int g = gt; g < p.ecap; g += gs) p.e_marks[g] = 0;
  for (int g = gt; g < p.lcap; g += gs) p.l_marks[g] = 0;
  for (int g = gt; g < p.trcap; g += gs) p.t_marks[g] = 0;
  for (int s = gt; s < NS; s += gs) {
    p.seg_start[s] = 0;
    p.seg_end[s] = 0;
    p.st_selected[s] = 0;
  }
  for (int i = gt; i < p.n_desc; i += gs) p.desc[0][i] = 0;
  for (long long i = gt; i < (long long)p.sort_tiles * kRadix; i += gs)
    p.sort_desc[i] = 0;
  for (int i = gt; i < 2 * kMaxPasses * kRadix; i += gs) p.hist[i] = 0;
  if (gt == 0) {
    p.meta[kSiteMin] = p.meta[kAlleleMin] = INT_MAX;
    p.meta[kSiteMax] = p.meta[kAlleleMax] = INT_MIN;
  }
  grid_sync(grid, 0);

  // ---- stage 0: FB_CHAIN, mapped; the pool states' table rows ----
  for (int i = gt; i < N; i += gs) {
    const int rid = p.f_rid[i];
    const int rc = clampi(rid, 0, R - 1);
    const bool alive = rid >= 0 && p.row_ok[rc];
    if (alive) {
      if (p.state_bad[i]) atomicOr(p.fallback + rc, kFbChain);
      p.mapped[rc] = 1;
    }
    const int nt = p.n_trav[i], ni = p.n_ing[i];
    const bool live = alive && (nt > 0 || ni > 0);
    p.ps_row[i] = rc;
    p.ps_lo[i] = p.f_lo[i];
    p.ps_hi[i] = p.f_hi[i];
    p.ps_ntrav[i] = live ? nt : 0;
    p.ps_ning[i] = live ? ni : 0;
    p.ps_live[i] = live;
    p.ing_parent[i] = ni > 0 ? p.ing[i * kTcap + clampi(ni - 1, 0, kTcap - 1)].x
                             : 0;
    if (live) atomicAdd(p.row_cnt + rc, 1);
  }
  if (p.stage <= 0) return;
  for (int k = gt; k < N * kTcap; k += gs) p.ps_trav[k] = p.trav[k];
  // the encapsulated split's widths (inputs only)
  width_scan(p, N, [&](int i) { return enc_width(p, i); },
             [&](int i) { return clampi(p.f_rid[i], 0, R - 1); }, p.ecap,
             p.cum_e, p.e_marks, kFbEnc, p.desc[kDescE], kTotalE, sm);
  grid_sync(grid, 0);

  // ---- stage 1: the encapsulated split ----
  // A tile of lanes: the marks' prefix max gives each lane its item; the
  // tile also works out the lanes just before and after it, so the run
  // starts and ends need no other tile; then the runs' starts' prefix max.
  {
    EncLane& L = ph.lane;
    const int T = (int)tiles_of(p.ecap, kThreads);
    for (int t = blockIdx.x; t < T; t += G) {
      const int g0 = t * kThreads, g = g0 + threadIdx.x, k = threadIdx.x + 1;
      int before;
      const int mark = tile_scan<Maxes>(
          g < p.ecap ? p.e_marks[g] : Maxes::id(), p.desc[kDescEm], t, sm,
          &before);
      if (g < p.ecap) enc_lane(p, g, mark, L, k);
      if (threadIdx.x == 0 && g0 > 0) enc_lane(p, g0 - 1, before, L, 0);
      if (threadIdx.x == kThreads - 1 && g + 1 < p.ecap)
        enc_lane(p, g + 1, max(mark, p.e_marks[g + 1]), L, k + 1);
      __syncthreads();
      auto enc = [&](int j) { return L.valid[j] && L.site[j] > 0; };
      // lane g0 - 1 + j: the same (item, site, allele) as the lane before
      auto prev_same = [&](int j) {
        return g0 - 1 + j > 0 && L.item[j] == L.item[j - 1]
            && L.site[j] == L.site[j - 1] && L.allele[j] == L.allele[j - 1]
            && enc(j - 1) && enc(j);
      };
      bool run_flag = false;
      if (g < p.ecap) {
        const int s = N + g;
        const bool start = enc(k) && !prev_same(k);
        const int row = clampi(p.f_rid[L.item[k]], 0, R - 1);
        if (L.valid[k] && L.site[k] == 0) atomicAdd(p.nonvar + row, 1);
        p.ps_row[s] = row;
        p.ps_lo[s] = L.occ[k];
        if (!start) p.ps_hi[s] = 0;      // a start lane's hi: its run's end
        p.ps_ntrav[s] = start;
        p.ps_ning[s] = 0;
        p.ps_live[s] = start;
        p.ing_parent[s] = 0;
        if (start) atomicAdd(p.row_cnt + row, 1);
        int2* trow = p.ps_trav + (size_t)s * kTcap;
        trow[0] = start ? make_int2(L.site[k], L.allele[k]) : make_int2(0, 0);
        for (int c = 1; c < kTcap; ++c) trow[c] = make_int2(0, 0);
        // a run's start lane (or a lane outside any run): segment_first's
        run_flag = !enc(k) || !prev_same(k);
      }
      const int first = tile_scan<Maxes>(
          g < p.ecap ? (run_flag ? g : 0) : Maxes::id(), p.desc[kDescRun], t,
          sm);
      if (g < p.ecap) {
        const bool next_same = g + 1 < p.ecap && prev_same(k + 1);
        if (enc(k) && !next_same) p.ps_hi[N + first] = L.occ[k];
      }
      __syncthreads();
    }
  }
  if (p.stage <= 1) return;
  grid_sync(grid, 0);

  // ---- stage 2: duplicate site in a live state's own path ----
  for (int s = gt; s < NS; s += gs)
    if (p.ps_live[s] && dup_site(p, s))
      atomicOr(p.fallback + p.ps_row[s], kFbDupSite);
  if (p.stage <= 2) return;

  // ---- stage 3: loci, ancestors, the dedup sort ----
  auto state_row = [&](int s) { return p.ps_row[s]; };
  width_scan(p, NS, [&](int s) { return loci_width(p, s); }, state_row,
             p.lcap, p.cum_l, p.l_marks, kFbLoci, p.desc[kDescL], kTotalL,
             sm);
  width_scan(p, NS, [&](int s) { return trav_width(p, s); }, state_row,
             p.trcap, p.cum_t, p.t_marks, kFbTrav, p.desc[kDescT], kTotalT,
             sm);
  // each row's first place among the live states bucketed by row
  {
    const int T = (int)tiles_of(R, kThreads);
    for (int t = blockIdx.x; t < T; t += G) {
      const int r = t * kThreads + threadIdx.x;
      const int c = r < R ? p.row_cnt[r] : 0;
      const int incl = tile_scan<Sums>(c, p.desc[kDescRows], t, sm);
      if (r < R) p.row_off[r] = p.row_cur[r] = incl - c;
    }
  }
  grid_sync(grid, 0);
  {
    int smin = INT_MAX, smax = INT_MIN, amin = INT_MAX, amax = INT_MIN;
    // a base lane b and its A ancestor lanes b + a * NB
    auto put = [&](int b, int state, int site, int allele, bool valid) {
      p.lane_key[b] = valid ? state : NS + 1;
      p.lane_site[b] = site;
      p.lane_allele[b] = allele;
      smin = min(smin, site); smax = max(smax, site);
      amin = min(amin, allele); amax = max(amax, allele);
      const int sidx = site_index(site, p.n_sites);
      const int len = p.anc_len[sidx];
      for (int a = 0; a < p.A; ++a) {
        const int as = p.anc_site[sidx * p.anc_stride + a];
        const int aa = p.anc_allele[sidx * p.anc_stride + a];
        const int l = b + (a + 1) * NB;
        p.lane_key[l] = valid && a < len ? state : NS + 1;
        p.lane_site[l] = as;
        p.lane_allele[l] = aa;
        smin = min(smin, as); smax = max(smax, as);
        amin = min(amin, aa); amax = max(amax, aa);
      }
    };
    marks_scan(p.lcap, p.l_marks, p.desc[kDescLm], sm, [&](int g, int mark) {
      const int item = clampi(mark - 1, 0, NS - 1);
      const int off = add_wrap(g, -add_wrap(p.cum_l[item],
                                            -loci_width(p, item)));
      const bool valid = g < min(p.meta[kTotalL], p.lcap);
      const int2 locus = p.ps_trav[(size_t)item * kTcap +
                                   clampi(off, 0, kTcap - 1)];
      put(g, item, locus.x, locus.y, valid && locus.x >= 5);
    });
    marks_scan(p.trcap, p.t_marks, p.desc[kDescTm], sm, [&](int g, int mark) {
      const int item = clampi(mark - 1, 0, NS - 1);
      const int off = add_wrap(g, -add_wrap(p.cum_t[item],
                                            -trav_width(p, item)));
      const bool valid = g < min(p.meta[kTotalT], p.trcap);
      const int occ = clampi(add_wrap(p.ps_lo[item], off), 0, p.sa_size - 1);
      const int node = p.ra_node[clampi(p.sa[occ], 0, p.n_ra - 1)];
      const int site = valid ? p.ing_parent[item] : 0;
      put(p.lcap + g, item, site, p.nt_allele[node], valid && site >= 5);
    });
    smin = block_reduce<Mins>(smin, sm);
    smax = block_reduce<Maxes>(smax, sm);
    amin = block_reduce<Mins>(amin, sm);
    amax = block_reduce<Maxes>(amax, sm);
    if (threadIdx.x == 0) {
      atomicMin(p.meta + kSiteMin, smin);
      atomicMax(p.meta + kSiteMax, smax);
      atomicMin(p.meta + kAlleleMin, amin);
      atomicMax(p.meta + kAlleleMax, amax);
    }
    for (int s = gt; s < NS; s += gs)
      if (p.ps_live[s]) p.bucket[atomicAdd(p.row_cur + p.ps_row[s], 1)] = s;
  }
  grid_sync(grid, 0);
  const Packing<K> pk = packing<K>(p.meta);
  const int bits = bits_of((unsigned)(NS + 1)) + pk.low();
  // the 64-bit instance holds what the host's bound promised, or traps
  if (sizeof(K) * 8 < 128
      && max(bits, bits_of((unsigned)(R + 1)) + pk.low()) > 64)
    __trap();
  const int F = pk.low() / 8, P = (bits + 7) / 8;
  sort_histogram<K>(LT, 0, P, p.hist, ph.hist, [&](int l) {
    const K k = pk.pack((unsigned)p.lane_key[l], p.lane_site[l],
                        p.lane_allele[l]);
    keys_a[l] = k;
    return k;
  });
  grid_sync(grid, 0);
  // the field passes, then the primary key's, each key's place in the
  // field order (buffer mid, which they leave as it is) going with it:
  // the triple sort starts from that order
  K* buf[3] = {keys_a, keys_b, static_cast<K*>(p.keys_c)};
  unsigned* vbuf[2] = {p.vals_a, p.vals_b};
  int mid = 0;
  for (int pass = 0; pass < F; ++pass)
    if (sort_step<K, false>(grid, 0, buf[mid], buf[mid ^ 1], nullptr,
                            nullptr, LT, pass, p.hist, p.sort_desc, 1,
                            ph.sort, sm))
      mid ^= 1;
  const int spare[2] = {2, mid ^ 1};
  int kc = mid, vc = -1, o = 0;
  for (int pass = F; pass < P; ++pass) {
    const int vd = vc < 0 ? 0 : vc ^ 1;
    if (sort_step<K, true>(grid, 0, buf[kc], buf[spare[o]],
                           vc < 0 ? nullptr : vbuf[vc], vbuf[vd], LT, pass,
                           p.hist, p.sort_desc, 1, ph.sort, sm)) {
      kc = spare[o];
      vc = vd;
      o ^= 1;
    }
  }
  const K* keys = buf[kc];
  const unsigned* place = vc < 0 ? nullptr : vbuf[vc];
  if (gt == 0) p.meta[kMid] = mid;
  // kept: the first of its equal run, and valid (state <= NS)
  auto kept = [&](int q) {
    return (q == 0 || keys[q] != keys[q - 1]) && pk.primary(keys[q]) <= NS;
  };
  for (int q = gt; q < LT; q += gs) {
    const K k = keys[q];
    const int state = pk.primary(k);
    const bool kq = kept(q);
    p.keep[q] = kq;
    p.keep_mid[place ? place[q] : q] = kq;
    if (kq && q > 0 && kept(q - 1)) {
      const K k1 = keys[q - 1];
      const int sc = min(state, NS - 1), sc1 = min(pk.primary(k1), NS - 1);
      if (sc == sc1 && pk.site(k) == pk.site(k1))
        atomicOr(p.fallback + p.ps_row[sc], kFbConflict);
    }
    if (state < NS) {
      if (q == 0 || pk.primary(keys[q - 1]) != state) p.seg_start[state] = q;
      if (q == LT - 1 || pk.primary(keys[q + 1]) != state)
        p.seg_end[state] = q + 1;
    }
  }
  if (p.stage <= 3) return;
  grid_sync(grid, 0);

  // ---- stages 4 and 5: a thread a row (a warp a row of more than
  // kSmallRow live states), tiles of kRowTile rows ----
  const bool trips = p.stage >= 5 && p.check_trips;
  const int T = (int)tiles_of(R, kRowTile);
  for (int t = blockIdx.x; t < T; t += G) {
    const int i = threadIdx.x, r = t * kRowTile + i;
    if (i == 0) ph.rows.n_big = 0;
    __syncthreads();
    int n = 0;
    const int k = r < R ? p.row_cnt[r] : 0;
    if (k > kSmallRow)
      ph.rows.big[atomicAdd(&ph.rows.n_big, 1)] = i;
    else if (k > 0)
      n = row_pick_thread(p, keys, pk, r, k);
    ph.rows.nsel[i] = n;
    __syncthreads();
    for (int b = warp; b < ph.rows.n_big; b += kWarps) {
      const int j = ph.rows.big[b];
      const int m = row_pick(p, keys, pk, t * kRowTile + j);
      if (lane == 0) ph.rows.nsel[j] = m;
    }
    __syncthreads();
    if (trips) {
      const int m = ph.rows.nsel[i];
      const int incl = tile_scan<Sums>(m, p.desc[kDescTrips], t, sm);
      if (m > 0 && incl > p.trip_cap) atomicOr(p.fallback + r, kFbTrips);
    }
    __syncthreads();
  }
  stamp_k8(0, 1);
}

// ---------------------------------------------------------------------------
// the second launch: the triples
// ---------------------------------------------------------------------------

template <class K>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
triples_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ ScanSmem sm;
  __shared__ PhaseSmem ph;
  const int R = p.R, NS = p.N + p.ecap;
  const int LT = (p.lcap + p.trcap) * (p.A + 1);
  const int gt = blockIdx.x * kThreads + threadIdx.x, gs = gridDim.x * kThreads;
#ifdef K8_SYNCS
  if (gt == 0) g_k8[1] = g_k8[3] = 0;
#endif
  stamp_k8(1, 0);
  // the keys in the dedup sort's field order (buffer mid), each with its
  // row key in place of its state; then only the row key's passes
  const Packing<K> pk = packing<K>(p.meta);
  const int mid = p.meta[kMid];
  K* buf[3] = {static_cast<K*>(p.keys_a), static_cast<K*>(p.keys_b),
               static_cast<K*>(p.keys_c)};
  const K* fields = buf[mid];
  K* a = buf[2];
  K* b = buf[mid ^ 1];
  const int F = pk.low() / 8;
  const int P = (bits_of((unsigned)(R + 1)) + pk.low() + 7) / 8;
  int* hist = p.hist + kMaxPasses * kRadix;
  sort_histogram<K>(LT, F, P, hist, ph.hist, [&](int i) {
    const K k = fields[i];
    const int st = min(pk.primary(k), NS - 1);
    const int r = p.ps_row[st];
    const bool sel = p.keep_mid[i] && p.st_selected[st] && p.fb_final[r] == 0;
    const K k2 = ((K)(unsigned)(sel ? r : R + 1) << pk.low()) | pk.fields(k);
    a[i] = k2;
    return k2;
  });
  grid_sync(grid, 1);
  int cur = 0;
  K* ab[2] = {a, b};
  for (int pass = F; pass < P; ++pass)
    if (sort_step<K, false>(grid, 1, ab[cur], ab[cur ^ 1], nullptr, nullptr,
                            LT, pass, hist, p.sort_desc, 1 + kMaxPasses,
                            ph.sort, sm))
      cur ^= 1;
  const K* sorted = ab[cur];
  for (int q = gt; q < p.trip_cap; q += gs) {
    if (q < LT) {
      const K k = sorted[q];
      p.t_row[q] = pk.primary(k);
      p.t_site[q] = pk.site(k);
      p.t_allele[q] = pk.allele(k);
    } else {
      p.t_row[q] = R + 1;
      p.t_site[q] = 0;
      p.t_allele[q] = 0;
    }
  }
  stamp_k8(1, 1);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// [kernel (select, triples) * 2 + instance (64, 128-bit keys)][device]
int g_grid[4][kMaxDevices];

template <class Kernel>
int coop_grid(Kernel kernel, int* cache) {
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
    per_sm = per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm;
    if (per_sm * sms < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

struct Dims {
  int N, R, ecap, lcap, trcap, A, kcap, grid, wide;
  long long NS() const { return (long long)N + ecap; }
  long long LT() const { return (long long)(lcap + trcap) * (A + 1); }
  long long key_bytes() const { return wide ? 16 : 8; }
  long long sort_tiles() const {
    return tiles_of(LT(), (long long)kThreads * sort_items(LT(), grid));
  }
  // the descriptor words of each chained scan
  long long desc_words(int which) const {
    switch (which) {
      case kDescE: return tiles_of(N, kThreads);
      case kDescEm: case kDescRun: return tiles_of(ecap, kThreads);
      case kDescL: case kDescT: return tiles_of(NS(), kThreads);
      case kDescRows: return tiles_of(R, kThreads);
      case kDescLm: return tiles_of(lcap, kThreads);
      case kDescTm: return tiles_of(trcap, kThreads);
      default: return tiles_of(R, kRowTile);
    }
  }
};

// Carves the scratch at ``base`` (null: only sizes it) into p's scratch
// pointers; returns its bytes.
long long carve(const Dims& d, char* base, Params* p) {
  long long off = 0;
  auto take = [&](long long bytes) {
    off = (off + 15) / 16 * 16;
    char* at = base ? base + off : nullptr;
    off += bytes;
    return at;
  };
  const long long NS = d.NS(), LT = d.LT();
  auto ints = [&](long long n) { return (int*)take(n * 4); };
  auto bytes = [&](long long n) { return (unsigned char*)take(n); };
  Params q;
  q.ps_ning = ints(NS);
  q.ing_parent = ints(NS);
  q.ps_live = bytes(NS);
  q.cum_e = ints(d.N);
  q.e_marks = ints(d.ecap);
  q.nonvar = ints(d.R);
  q.cum_l = ints(NS);
  q.cum_t = ints(NS);
  q.l_marks = ints(d.lcap);
  q.t_marks = ints(d.trcap);
  q.lane_key = ints(LT);
  q.lane_site = ints(LT);
  q.lane_allele = ints(LT);
  q.keys_a = take(LT * d.key_bytes());
  q.keys_b = take(LT * d.key_bytes());
  q.keys_c = take(LT * d.key_bytes());
  q.vals_a = (unsigned*)ints(LT);
  q.vals_b = (unsigned*)ints(LT);
  q.keep = bytes(LT);
  q.keep_mid = bytes(LT);
  q.hist = ints(2 * kMaxPasses * kRadix);
  q.seg_start = ints(NS);
  q.seg_end = ints(NS);
  q.key_mat = ints(NS * d.kcap);
  q.row_cnt = ints(d.R);
  q.row_off = ints(d.R);
  q.row_cur = ints(d.R);
  q.bucket = ints(NS);
  q.first_occ = bytes(NS);
  long long words = 0;
  for (int i = 0; i < kDescs; ++i) words += d.desc_words(i);
  Word* desc = (Word*)take(words * 8);
  q.n_desc = (int)words;
  for (int i = 0; i < kDescs; ++i) {
    q.desc[i] = desc;
    if (desc) desc += d.desc_words(i);
  }
  q.sort_tiles = (int)d.sort_tiles();
  q.sort_desc = (Word*)take(d.sort_tiles() * kRadix * 8);
  q.meta = ints(kMeta);
  if (p) {
    p->ps_ning = q.ps_ning; p->ing_parent = q.ing_parent;
    p->ps_live = q.ps_live; p->cum_e = q.cum_e; p->e_marks = q.e_marks;
    p->nonvar = q.nonvar; p->cum_l = q.cum_l; p->cum_t = q.cum_t;
    p->l_marks = q.l_marks; p->t_marks = q.t_marks;
    p->lane_key = q.lane_key; p->lane_site = q.lane_site;
    p->lane_allele = q.lane_allele; p->keys_a = q.keys_a;
    p->keys_b = q.keys_b; p->keys_c = q.keys_c; p->vals_a = q.vals_a;
    p->vals_b = q.vals_b; p->keep = q.keep; p->keep_mid = q.keep_mid;
    p->hist = q.hist;
    p->seg_start = q.seg_start; p->seg_end = q.seg_end;
    p->key_mat = q.key_mat; p->row_cnt = q.row_cnt; p->row_off = q.row_off;
    p->row_cur = q.row_cur; p->bucket = q.bucket;
    p->first_occ = q.first_occ;
    for (int i = 0; i < kDescs; ++i) p->desc[i] = q.desc[i];
    p->n_desc = q.n_desc; p->sort_tiles = q.sort_tiles;
    p->sort_desc = q.sort_desc; p->meta = q.meta;
  }
  return off + 16;
}

}  // namespace

// the cooperative grid of both launches of an instance (wide: 128-bit keys)
// on the current device (the smaller of the two kernels' co-resident
// blocks, at most kBlocksPerSm an SM); -(CUDA error) on failure
extern "C" int select_grid(int wide) {
  const int a = wide ? coop_grid(select_kernel<u128>, g_grid[1])
                     : coop_grid(select_kernel<uint64_t>, g_grid[0]);
  const int b = wide ? coop_grid(triples_kernel<u128>, g_grid[3])
                     : coop_grid(triples_kernel<uint64_t>, g_grid[2]);
  if (a < 0) return a;
  if (b < 0) return b;
  return a < b ? a : b;
}

extern "C" long long select_scratch_bytes(int N, int R, int ecap, int lcap,
                                          int trcap, int A, int kcap,
                                          int grid, int wide) {
  const Dims d{N, R, ecap, lcap, trcap, A, kcap, grid, wide ? 1 : 0};
  return carve(d, nullptr, nullptr);
}

// the byte offset in the scratch of field 0: row_cnt (R ints, each row's
// live states), 1: seg_start, 2: seg_end (NS ints each, each state's run
// of sorted lanes), for the smoke's stage-4 counts
extern "C" long long select_scratch_offset(int field, int N, int R, int ecap,
                                           int lcap, int trcap, int A,
                                           int kcap, int grid, int wide) {
  const Dims d{N, R, ecap, lcap, trcap, A, kcap, grid, wide ? 1 : 0};
  char* const base = reinterpret_cast<char*>(uintptr_t(1) << 40);
  Params p;
  carve(d, base, &p);
  const void* at = field == 0 ? (const void*)p.row_cnt
                 : field == 1 ? (const void*)p.seg_start
                              : (const void*)p.seg_end;
  return (long long)(static_cast<const char*>(at) - base);
}

// registers, local bytes and static shared bytes of a kernel (which 0:
// select_kernel, 1: triples_kernel) of an instance
extern "C" int select_attrs(int* out, int which, int wide) {
  cudaFuncAttributes a;
  const void* fn =
      which == 0 ? (wide ? (const void*)select_kernel<u128>
                         : (const void*)select_kernel<uint64_t>)
                 : (wide ? (const void*)triples_kernel<u128>
                         : (const void*)triples_kernel<uint64_t>);
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

#ifdef K8_SYNCS
// the last launches' grid syncs and sort passes (g_k8) into out[0..4),
// their stamps (g_k8_t, kK8Stamps a launch) after them
extern "C" int select_syncs(long long* out) {
  constexpr int n = 4 + 2 * kK8Stamps + 2 * kMaxPasses * 2 * 4;
  unsigned long long v[n];
  cudaError_t err = cudaMemcpyFromSymbol(v, g_k8, 4 * sizeof(v[0]));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(v + 4, g_k8_t, 2 * kK8Stamps * sizeof(v[0]));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(v + 4 + 2 * kK8Stamps, g_k8_p,
                               2 * kMaxPasses * 2 * 4 * sizeof(v[0]));
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n; ++i) out[i] = (long long)v[i];
  return 0;
}
#endif

// which = 0: the selection (select_kernel, stages up to ``stage``);
// which = 1: the triples (triples_kernel) after K9, on the same scratch;
// wide: the 128-bit key instance, else the 64-bit one
extern "C" int select_launch(
    int which, int N, const void* f_rid, const void* f_lo, const void* f_hi,
    const void* trav, const void* n_trav, const void* ing, const void* n_ing,
    const void* state_bad, int R, const void* row_ok,
    const void* row_first_raw, const void* sa, int sa_size,
    const void* ra_node, int n_ra, const void* nt_site,
    const void* nt_allele, const void* anc_len, const void* anc_site,
    const void* anc_allele, const void* base_site, int n_sites,
    int anc_stride, int A, int ecap, int lcap, int trcap, int kcap,
    int trip_cap, int stage, int wide, void* fallback, void* mapped,
    void* ps_row, void* ps_lo, void* ps_hi, void* ps_trav, void* ps_ntrav,
    void* st_selected, const void* fb_final, void* t_row, void* t_site,
    void* t_allele, void* scratch, int grid, void* stream) {
  if (kcap < 1 || kcap > kMaxKcap) return (int)cudaErrorInvalidValue;
  Params p;
  p.N = N;
  p.f_rid = static_cast<const int*>(f_rid);
  p.f_lo = static_cast<const int*>(f_lo);
  p.f_hi = static_cast<const int*>(f_hi);
  p.trav = static_cast<const int2*>(trav);
  p.n_trav = static_cast<const int*>(n_trav);
  p.ing = static_cast<const int2*>(ing);
  p.n_ing = static_cast<const int*>(n_ing);
  p.state_bad = static_cast<const unsigned char*>(state_bad);
  p.R = R;
  p.row_ok = static_cast<const unsigned char*>(row_ok);
  p.row_first_raw = static_cast<const long long*>(row_first_raw);
  p.sa = static_cast<const int*>(sa);
  p.sa_size = sa_size;
  p.ra_node = static_cast<const int*>(ra_node);
  p.n_ra = n_ra;
  p.nt_site = static_cast<const int*>(nt_site);
  p.nt_allele = static_cast<const int*>(nt_allele);
  p.anc_len = static_cast<const int*>(anc_len);
  p.anc_site = static_cast<const int*>(anc_site);
  p.anc_allele = static_cast<const int*>(anc_allele);
  p.base_site = static_cast<const int*>(base_site);
  p.n_sites = n_sites;
  p.anc_stride = anc_stride;
  p.A = A;
  p.ecap = ecap;
  p.lcap = lcap;
  p.trcap = trcap;
  p.kcap = kcap;
  p.trip_cap = trip_cap;
  const Dims d{N, R, ecap, lcap, trcap, A, kcap, grid, wide ? 1 : 0};
  p.check_trips = d.LT() > trip_cap;
  p.stage = stage;
  p.fallback = static_cast<int*>(fallback);
  p.mapped = static_cast<unsigned char*>(mapped);
  p.ps_row = static_cast<int*>(ps_row);
  p.ps_lo = static_cast<int*>(ps_lo);
  p.ps_hi = static_cast<int*>(ps_hi);
  p.ps_trav = static_cast<int2*>(ps_trav);
  p.ps_ntrav = static_cast<int*>(ps_ntrav);
  p.st_selected = static_cast<unsigned char*>(st_selected);
  p.fb_final = static_cast<const int*>(fb_final);
  p.t_row = static_cast<int*>(t_row);
  p.t_site = static_cast<int*>(t_site);
  p.t_allele = static_cast<int*>(t_allele);
  carve(d, static_cast<char*>(scratch), &p);
  void* args[] = {&p};
  const void* fn =
      which == 0 ? (wide ? (const void*)select_kernel<u128>
                         : (const void*)select_kernel<uint64_t>)
                 : (wide ? (const void*)triples_kernel<u128>
                         : (const void*)triples_kernel<uint64_t>);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, 0,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
