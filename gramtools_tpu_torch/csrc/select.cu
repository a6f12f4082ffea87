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
//     4  each live state's key row (its first KCAP distinct base sites,
//        ascending, padded with -1; FB_KCAP past them) from its run of
//        the sorted lanes; the live states bucketed by row (a count, a
//        scan, a scatter); a warp a row ranks its states' key rows
//        (class_ord: the distinct key rows below a state's own; the
//        classes: the distinct key rows) and makes the pick
//        (libstdc++'s uniform_int first draw, FB_RNG), marking the
//        chosen class's states selected;
//     5  where LT > trip_cap, FB_TRIPS on each row whose selected kept
//        lanes reach past trip_cap in row order (a count a row, a scan).
//   triples_kernel  (after K9) each lane's row key (the row of a kept
//        lane of a selected state whose row has no fallback bit, R + 1
//        else) and one radix sort of (row key, site, allele) over every
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
// The radix sort: keys of up to 128 bits, (primary << (sb + ab)) |
// (site - site_min) << ab | (allele - allele_min), where sb and ab are the
// bits of the site and allele ranges over the lanes (a min/max reduction
// in the launch), so the passes are as many as the data needs: a
// 20,000-read buffer (R = 30,720 rows, NS = 43,008 states) on a graph of
// 100,000 biallelic sites (site markers below 2^18, alleles -1..1) needs
// 16 + 18 + 2 bits for the dedup sort and 15 + 18 + 2 for the triple
// sort, 9 passes of 4-bit digits each. A pass is a tile histogram
// (2,048 keys a tile, one counter column a thread) and a stable scatter
// (each digit's place: the digits below it, the tiles before this one,
// the threads before this one, the keys before this one in the thread).
//
// A launch is a cooperative grid (the blocks co-resident on the card, at
// most kBlocksPerSm an SM): the phases are grid-stride loops or chunked
// scans (a block's chunk reduced, a grid sync, each block's carry the
// fold of the chunks before it) separated by grid syncs, about 40 in the
// first launch and 20 in the second. ``stage`` (GRAMTOOLS_TPU_RECORD_STAGE)
// stops the first launch after the numbered block, as the jnp code
// returns there.
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers, its scratch and PyTorch's current stream; the launch
// functions return the launch's cudaError_t, 0 on success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                    // keys a thread in a sort tile
constexpr int kTile = kThreads * kItems;
constexpr int kDigits = 16;                  // 4-bit radix digits
constexpr int kTcap = 16;                    // search_log_host.TCAP
constexpr int kMaxKcap = 12;                 // search_log_host.KCAP
constexpr int kBlocksPerSm = 2;
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xFFFFFFFFu;

// search_log_host.FB_*
constexpr int kFbChain = 1, kFbEnc = 2, kFbDupSite = 4, kFbTrav = 8,
              kFbKcap = 16, kFbConflict = 32, kFbRng = 64, kFbTrips = 128,
              kFbLoci = 1024;

typedef unsigned __int128 u128;

// meta words
enum { kSiteMin, kSiteMax, kAlleleMin, kAlleleMax, kTotalE, kTotalL,
       kTotalT, kSorted, kMeta = 16 };
// chunk aggregates, one row of G each
enum { kAggE, kAggEm, kAggRun, kAggL, kAggT, kAggLm, kAggTm, kAggRows,
       kAggTrips, kAggs };

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
  int* cum_e;
  int* e_marks;
  int* e_item;
  int* occ_sa;
  int* occ_site;
  int* occ_allele;
  unsigned char* e_valid;
  unsigned char* ps_live;
  int* nonvar;
  int* cum_l;
  int* cum_t;
  int* l_marks;
  int* t_marks;
  int* lane_key;
  int* lane_site;
  int* lane_allele;
  u128* keys_a;
  u128* keys_b;
  unsigned char* keep;
  int* hist;
  int* seg_start;
  int* seg_end;
  int* key_mat;                     // (NS, kcap)
  int* row_cnt;
  int* row_off;
  int* row_cur;
  int* bucket;
  unsigned char* first_occ;
  int* n_sel;
  int* agg;                         // (kAggs, grid)
  int* meta;
};

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

// Op over the block's values; every thread gets it. ws: kWarps ints.
template <class Op>
__device__ int block_reduce(int v, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_reduce<Op>(v);
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  int r = Op::id();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r = Op::f(r, ws[w]);
  __syncthreads();
  return r;
}

// inclusive Op-scan over the block's threads; *total: the block's fold
template <class Op>
__device__ int block_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x = Op::f(y, x);
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  int before = Op::id(), all = Op::id();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = Op::f(before, ws[w]);
    all = Op::f(all, ws[w]);
  }
  __syncthreads();
  *total = all;
  return Op::f(before, x);
}

// [lo, hi): block blockIdx.x's chunk of n items
__device__ __forceinline__ void chunk(int n, int& lo, int& hi) {
  const long long per = ((long long)n + gridDim.x - 1) / gridDim.x;
  lo = (int)min((long long)n, per * blockIdx.x);
  hi = (int)min((long long)n, (long long)lo + per);
}

// agg[blockIdx.x] = the Op-fold of value(i) over the block's chunk
template <class Op, class F>
__device__ void reduce_chunk(int n, F value, int* agg, int* ws) {
  int lo, hi;
  chunk(n, lo, hi);
  int acc = Op::id();
  for (int i = lo + (int)threadIdx.x; i < hi; i += kThreads)
    acc = Op::f(acc, value(i));
  acc = block_reduce<Op>(acc, ws);
  if (threadIdx.x == 0) agg[blockIdx.x] = acc;
}

// emit(i, the inclusive Op-scan of value up to i) over the block's chunk,
// its carry the fold of the chunks before it (agg, from reduce_chunk)
template <class Op, class F, class E>
__device__ void scan_chunk(int n, F value, const int* agg, int* ws, E emit) {
  int carry = Op::id();
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kThreads)
    carry = Op::f(carry, agg[b]);
  carry = block_reduce<Op>(carry, ws);
  int lo, hi;
  chunk(n, lo, hi);
  for (int base = lo; base < hi; base += kThreads) {
    const int i = base + threadIdx.x;
    const int v = i < hi ? value(i) : Op::id();
    int total;
    const int incl = block_scan<Op>(v, ws, &total);
    if (i < hi) emit(i, Op::f(carry, incl));
    carry = Op::f(carry, total);
  }
}

// ---------------------------------------------------------------------------
// the radix sort
// ---------------------------------------------------------------------------

struct SortSmem {
  int cnt[kDigits * kThreads];     // a counter column a thread
  int tot[kDigits];
  int base[kDigits];
};

__device__ __forceinline__ int digit(u128 k, int shift) {
  return (int)(k >> shift) & (kDigits - 1);
}

// the thread's column of digit counts over its kItems keys of tile t
__device__ void count_digits(const u128* src, int n, int shift, int t,
                             int* cnt) {
#pragma unroll
  for (int d = 0; d < kDigits; ++d) cnt[d * kThreads + threadIdx.x] = 0;
  const int first = t * kTile + threadIdx.x * kItems;
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (first + j < n) ++cnt[digit(src[first + j], shift) * kThreads +
                             threadIdx.x];
  __syncthreads();
}

// hist[d * T + t]: the keys of tile t with digit d
__device__ void sort_hist(const u128* src, int n, int shift, int* hist,
                          int T, SortSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    count_digits(src, n, shift, t, s.cnt);
    for (int d = warp; d < kDigits; d += kWarps) {
      int v = 0;
      for (int q = lane; q < kThreads; q += 32) v += s.cnt[d * kThreads + q];
      v = warp_reduce<Sums>(v);
      if (lane == 0) hist[d * T + t] = v;
    }
    __syncthreads();
  }
}

// each key of each tile to its stable place in dst
__device__ void sort_scatter(const u128* src, u128* dst, int n, int shift,
                             const int* hist, int T, SortSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPer = kThreads / 32;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    count_digits(src, n, shift, t, s.cnt);
    for (int d = warp; d < kDigits; d += kWarps) {
      // the threads before each thread, within digit d
      int* col = s.cnt + d * kThreads;
      int v[kPer], sum = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        v[q] = col[lane * kPer + q];
        sum += v[q];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += y;
      }
      int ex = incl - sum;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        col[lane * kPer + q] = ex;
        ex += v[q];
      }
      // digit d's keys in all tiles, and in the tiles before t
      int all = 0, before = 0;
      for (int q = lane; q < T; q += 32) {
        const int h = hist[d * T + q];
        all += h;
        if (q < t) before += h;
      }
      all = warp_reduce<Sums>(all);
      before = warp_reduce<Sums>(before);
      if (lane == 0) {
        s.tot[d] = all;
        s.base[d] = before;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int d = 0; d < kDigits; ++d) {
        s.base[d] += run;
        run += s.tot[d];
      }
    }
    __syncthreads();
    const int first = t * kTile + threadIdx.x * kItems;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (first + j < n) {
        const u128 k = src[first + j];
        const int d = digit(k, shift);
        dst[s.base[d] + s.cnt[d * kThreads + threadIdx.x]++] = k;
      }
    }
    __syncthreads();
  }
}

// Stable LSD sort of n keys by their low ``bits`` bits, between a and b;
// returns the buffer that holds the result (0: a, 1: b). Every block calls
// it with the same arguments.
__device__ int radix_sort(cg::grid_group& grid, u128* a, u128* b, int n,
                          int bits, int* hist, SortSmem& s) {
  const int T = (n + kTile - 1) / kTile;
  u128* buf[2] = {a, b};
  int cur = 0;
  for (int shift = 0; shift < bits; shift += 4) {
    sort_hist(buf[cur], n, shift, hist, T, s);
    grid.sync();
    sort_scatter(buf[cur], buf[cur ^ 1], n, shift, hist, T, s);
    grid.sync();
    cur ^= 1;
  }
  return cur;
}

// the packing of (site, allele) under a primary key
struct Packing {
  int smin, amin, sb, ab;
  __device__ int low() const { return sb + ab; }
  __device__ u128 pack(unsigned primary, int site, int allele) const {
    return ((u128)primary << low())
        | ((u128)((unsigned)site - (unsigned)smin) << ab)
        | (u128)((unsigned)allele - (unsigned)amin);
  }
  __device__ int primary(u128 k) const { return (int)(k >> low()); }
  __device__ int site(u128 k) const {
    const unsigned f = (unsigned)((k >> ab) & (((u128)1 << sb) - 1));
    return (int)(f + (unsigned)smin);
  }
  __device__ int allele(u128 k) const {
    const unsigned f = (unsigned)(k & (((u128)1 << ab) - 1));
    return (int)(f + (unsigned)amin);
  }
  __device__ u128 fields(u128 k) const {
    return k & (((u128)1 << low()) - 1);
  }
};

__device__ Packing packing(const int* meta) {
  Packing p;
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

// ---------------------------------------------------------------------------
// the first launch: stages 0-5
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) select_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int ws[kWarps];
  __shared__ SortSmem ss;
  const int N = p.N, R = p.R, NS = p.N + p.ecap, G = gridDim.x;
  const int NB = p.lcap + p.trcap, LT = NB * (p.A + 1);
  const int gt = blockIdx.x * kThreads + threadIdx.x, gs = G * kThreads;
  const int lane = threadIdx.x & 31;
  const int gw = gt >> 5, nw = gs >> 5;
  int* agg = p.agg;

  // ---- zero the accumulators ----
  for (int r = gt; r < R; r += gs) {
    p.fallback[r] = 0;
    p.mapped[r] = 0;
    p.nonvar[r] = 0;
    p.row_cnt[r] = 0;
    p.n_sel[r] = 0;
  }
  for (int g = gt; g < p.ecap; g += gs) p.e_marks[g] = 0;
  for (int g = gt; g < p.lcap; g += gs) p.l_marks[g] = 0;
  for (int g = gt; g < p.trcap; g += gs) p.t_marks[g] = 0;
  for (int s = gt; s < NS; s += gs) {
    p.seg_start[s] = 0;
    p.seg_end[s] = 0;
    p.st_selected[s] = 0;
  }
  if (gt == 0) {
    p.meta[kSiteMin] = p.meta[kAlleleMin] = INT_MAX;
    p.meta[kSiteMax] = p.meta[kAlleleMax] = INT_MIN;
  }
  grid.sync();

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
  }
  if (p.stage <= 0) return;
  for (int k = gt; k < N * kTcap; k += gs) p.ps_trav[k] = p.trav[k];
  reduce_chunk<Sums>(N, [&](int i) { return enc_width(p, i); },
                     agg + kAggE * G, ws);
  grid.sync();

  // ---- stage 1: the encapsulated split ----
  scan_chunk<Sums>(N, [&](int i) { return enc_width(p, i); },
                   agg + kAggE * G, ws, [&](int i, int cum) {
    expand_emit(i, cum, enc_width(p, i), p.ecap, p.cum_e, p.e_marks,
                p.fallback, clampi(p.f_rid[i], 0, R - 1), kFbEnc);
    if (i == N - 1) p.meta[kTotalE] = cum;
  });
  grid.sync();
  reduce_chunk<Maxes>(p.ecap, [&](int g) { return p.e_marks[g]; },
                      agg + kAggEm * G, ws);
  grid.sync();
  scan_chunk<Maxes>(p.ecap, [&](int g) { return p.e_marks[g]; },
                    agg + kAggEm * G, ws, [&](int g, int mark) {
    const int item = clampi(mark - 1, 0, N - 1);
    const int start = add_wrap(p.cum_e[item], -enc_width(p, item));
    const int off = add_wrap(g, -start);
    const bool valid = g < min(p.meta[kTotalE], p.ecap);
    const int occ = clampi(add_wrap(p.f_lo[item], off), 0, p.sa_size - 1);
    const int node = p.ra_node[clampi(p.sa[occ], 0, p.n_ra - 1)];
    const int site = valid ? p.nt_site[node] : 0;
    p.e_item[g] = item;
    p.occ_sa[g] = occ;
    p.occ_site[g] = site;
    p.occ_allele[g] = p.nt_allele[node];
    p.e_valid[g] = valid;
    if (valid && site == 0)
      atomicAdd(p.nonvar + clampi(p.f_rid[item], 0, R - 1), 1);
  });
  grid.sync();
  // lane g: enc, the same (item, site, allele) as lane g - 1 (prev_same)
  auto enc = [&](int g) { return p.e_valid[g] && p.occ_site[g] > 0; };
  auto prev_same = [&](int g) {
    return g > 0 && p.e_item[g] == p.e_item[g - 1]
        && p.occ_site[g] == p.occ_site[g - 1]
        && p.occ_allele[g] == p.occ_allele[g - 1] && enc(g - 1) && enc(g);
  };
  // a run's start lane (or a lane outside any run): segment_first's flag
  auto run_flag = [&](int g) { return !enc(g) || !prev_same(g); };
  for (int g = gt; g < p.ecap; g += gs) {
    const int s = N + g;
    const bool start = enc(g) && !prev_same(g);
    p.ps_row[s] = clampi(p.f_rid[p.e_item[g]], 0, R - 1);
    p.ps_lo[s] = p.occ_sa[g];
    if (!start) p.ps_hi[s] = 0;        // a start lane's hi: its run's end
    p.ps_ntrav[s] = start;
    p.ps_ning[s] = 0;
    p.ps_live[s] = start;
    p.ing_parent[s] = 0;
    int2* row = p.ps_trav + (size_t)s * kTcap;
    row[0] = start ? make_int2(p.occ_site[g], p.occ_allele[g])
                   : make_int2(0, 0);
    for (int k = 1; k < kTcap; ++k) row[k] = make_int2(0, 0);
  }
  reduce_chunk<Maxes>(p.ecap, [&](int g) { return run_flag(g) ? g : 0; },
                      agg + kAggRun * G, ws);
  grid.sync();
  scan_chunk<Maxes>(p.ecap, [&](int g) { return run_flag(g) ? g : 0; },
                    agg + kAggRun * G, ws, [&](int g, int first) {
    const bool next_same = g + 1 < p.ecap && prev_same(g + 1);
    if (enc(g) && !next_same) p.ps_hi[N + first] = p.occ_sa[g];
  });
  if (p.stage <= 1) return;

  // ---- stage 2: duplicate site in a live state's own path ----
  for (int s = gt; s < NS; s += gs)
    if (p.ps_live[s] && dup_site(p, s))
      atomicOr(p.fallback + p.ps_row[s], kFbDupSite);
  if (p.stage <= 2) return;

  // ---- stage 3: loci, ancestors, the dedup sort ----
  // (a trav width reads ps_hi only where ps_ning > 0: pool states, whose
  // hi the stage-0 loop wrote, so the run ends above may still be landing)
  reduce_chunk<Sums>(NS, [&](int s) { return loci_width(p, s); },
                     agg + kAggL * G, ws);
  reduce_chunk<Sums>(NS, [&](int s) { return trav_width(p, s); },
                     agg + kAggT * G, ws);
  grid.sync();
  scan_chunk<Sums>(NS, [&](int s) { return loci_width(p, s); },
                   agg + kAggL * G, ws, [&](int s, int cum) {
    expand_emit(s, cum, loci_width(p, s), p.lcap, p.cum_l, p.l_marks,
                p.fallback, p.ps_row[s], kFbLoci);
    if (s == NS - 1) p.meta[kTotalL] = cum;
  });
  scan_chunk<Sums>(NS, [&](int s) { return trav_width(p, s); },
                   agg + kAggT * G, ws, [&](int s, int cum) {
    expand_emit(s, cum, trav_width(p, s), p.trcap, p.cum_t, p.t_marks,
                p.fallback, p.ps_row[s], kFbTrav);
    if (s == NS - 1) p.meta[kTotalT] = cum;
  });
  grid.sync();
  reduce_chunk<Maxes>(p.lcap, [&](int g) { return p.l_marks[g]; },
                      agg + kAggLm * G, ws);
  reduce_chunk<Maxes>(p.trcap, [&](int g) { return p.t_marks[g]; },
                      agg + kAggTm * G, ws);
  grid.sync();
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
    scan_chunk<Maxes>(p.lcap, [&](int g) { return p.l_marks[g]; },
                      agg + kAggLm * G, ws, [&](int g, int mark) {
      const int item = clampi(mark - 1, 0, NS - 1);
      const int off = add_wrap(g, -add_wrap(p.cum_l[item],
                                            -loci_width(p, item)));
      const bool valid = g < min(p.meta[kTotalL], p.lcap);
      const int2 locus = p.ps_trav[(size_t)item * kTcap +
                                   clampi(off, 0, kTcap - 1)];
      put(g, item, locus.x, locus.y, valid && locus.x >= 5);
    });
    scan_chunk<Maxes>(p.trcap, [&](int g) { return p.t_marks[g]; },
                      agg + kAggTm * G, ws, [&](int g, int mark) {
      const int item = clampi(mark - 1, 0, NS - 1);
      const int off = add_wrap(g, -add_wrap(p.cum_t[item],
                                            -trav_width(p, item)));
      const bool valid = g < min(p.meta[kTotalT], p.trcap);
      const int occ = clampi(add_wrap(p.ps_lo[item], off), 0, p.sa_size - 1);
      const int node = p.ra_node[clampi(p.sa[occ], 0, p.n_ra - 1)];
      const int site = valid ? p.ing_parent[item] : 0;
      put(p.lcap + g, item, site, p.nt_allele[node], valid && site >= 5);
    });
    smin = block_reduce<Mins>(smin, ws);
    smax = block_reduce<Maxes>(smax, ws);
    amin = block_reduce<Mins>(amin, ws);
    amax = block_reduce<Maxes>(amax, ws);
    if (threadIdx.x == 0) {
      atomicMin(p.meta + kSiteMin, smin);
      atomicMax(p.meta + kSiteMax, smax);
      atomicMin(p.meta + kAlleleMin, amin);
      atomicMax(p.meta + kAlleleMax, amax);
    }
  }
  grid.sync();
  const Packing pk = packing(p.meta);
  for (int l = gt; l < LT; l += gs)
    p.keys_a[l] = pk.pack((unsigned)p.lane_key[l], p.lane_site[l],
                          p.lane_allele[l]);
  grid.sync();
  const int bits = bits_of((unsigned)(NS + 1)) + pk.low();
  const int cur = radix_sort(grid, p.keys_a, p.keys_b, LT, bits, p.hist, ss);
  const u128* keys = cur ? p.keys_b : p.keys_a;
  if (gt == 0) p.meta[kSorted] = cur;
  // kept: the first of its equal run, and valid (state <= NS)
  auto kept = [&](int q) {
    return (q == 0 || keys[q] != keys[q - 1]) && pk.primary(keys[q]) <= NS;
  };
  for (int q = gt; q < LT; q += gs) {
    const u128 k = keys[q];
    const int state = pk.primary(k);
    const bool kq = kept(q);
    p.keep[q] = kq;
    if (kq && q > 0 && kept(q - 1)) {
      const u128 k1 = keys[q - 1];
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
  grid.sync();

  // ---- stage 4: key rows, classes, the pick ----
  const int kcap = p.kcap;
  for (int s = gw; s < NS; s += nw) {
    if (!p.ps_live[s]) continue;
    if (lane == 0) atomicAdd(p.row_cnt + p.ps_row[s], 1);
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
    if (over && lane == 0) atomicOr(p.fallback + p.ps_row[s], kFbKcap);
  }
  grid.sync();
  reduce_chunk<Sums>(R, [&](int r) { return p.row_cnt[r]; },
                     agg + kAggRows * G, ws);
  grid.sync();
  scan_chunk<Sums>(R, [&](int r) { return p.row_cnt[r]; },
                   agg + kAggRows * G, ws, [&](int r, int incl) {
    p.row_off[r] = p.row_cur[r] = incl - p.row_cnt[r];
  });
  grid.sync();
  for (int s = gt; s < NS; s += gs)
    if (p.ps_live[s])
      p.bucket[atomicAdd(p.row_cur + p.ps_row[s], 1)] = s;
  grid.sync();
  for (int r = gw; r < R; r += nw) {
    const int k = p.row_cnt[r];
    if (k == 0) continue;
    const int* st = p.bucket + p.row_off[r];
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
    if (lane == 0 && active && rdraw >= totals * scaling)
      atomicOr(p.fallback + r, kFbRng);
    const int selected = add_wrap(1, (int)(rdraw / (scaling < 1 ? 1 : scaling)));
    const int chosen = add_wrap(add_wrap(selected, -nv), -1);
    const bool record = active && chosen >= 0 && chosen < n_classes;
    for (int i = lane; i < k && record; i += 32) {
      int ord = 0;
      for (int j = 0; j < k; ++j)
        ord += first[j] && key_cmp(key(j), key(i), kcap) < 0;
      if (ord == chosen) p.st_selected[st[i]] = 1;
    }
    __syncwarp();
  }
  if (p.stage <= 4 || !p.check_trips) return;
  grid.sync();

  // ---- stage 5: the preliminary triple-capacity check ----
  for (int q = gt; q < LT; q += gs) {
    if (!p.keep[q]) continue;
    const int s = min(pk.primary(keys[q]), NS - 1);
    const int r = p.ps_row[s];
    if (p.st_selected[s] && p.fallback[r] == 0) atomicAdd(p.n_sel + r, 1);
  }
  grid.sync();
  reduce_chunk<Sums>(R, [&](int r) { return p.n_sel[r]; },
                     agg + kAggTrips * G, ws);
  grid.sync();
  scan_chunk<Sums>(R, [&](int r) { return p.n_sel[r]; },
                   agg + kAggTrips * G, ws, [&](int r, int incl) {
    if (p.n_sel[r] > 0 && incl > p.trip_cap) atomicOr(p.fallback + r, kFbTrips);
  });
}

// ---------------------------------------------------------------------------
// the second launch: the triples
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) triples_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ SortSmem ss;
  const int R = p.R, NS = p.N + p.ecap;
  const int LT = (p.lcap + p.trcap) * (p.A + 1);
  const int gt = blockIdx.x * kThreads + threadIdx.x, gs = gridDim.x * kThreads;
  const Packing pk = packing(p.meta);
  const int cur = p.meta[kSorted];
  const u128* keys = cur ? p.keys_b : p.keys_a;
  u128* out = cur ? p.keys_a : p.keys_b;
  for (int q = gt; q < LT; q += gs) {
    const u128 k = keys[q];
    const int s = min(pk.primary(k), NS - 1);
    const int r = p.ps_row[s];
    const bool sel = p.keep[q] && p.st_selected[s] && p.fb_final[r] == 0;
    out[q] = ((u128)(unsigned)(sel ? r : R + 1) << pk.low()) | pk.fields(k);
  }
  grid.sync();
  const int bits = bits_of((unsigned)(R + 1)) + pk.low();
  u128* a = cur ? p.keys_a : p.keys_b;
  u128* b = cur ? p.keys_b : p.keys_a;
  const u128* sorted = radix_sort(grid, a, b, LT, bits, p.hist, ss) ? b : a;
  for (int q = gt; q < p.trip_cap; q += gs) {
    if (q < LT) {
      const u128 k = sorted[q];
      p.t_row[q] = pk.primary(k);
      p.t_site[q] = pk.site(k);
      p.t_allele[q] = pk.allele(k);
    } else {
      p.t_row[q] = R + 1;
      p.t_site[q] = 0;
      p.t_allele[q] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int g_grid[2][kMaxDevices];

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
  int N, R, ecap, lcap, trcap, A, kcap, grid;
  long long NS() const { return (long long)N + ecap; }
  long long LT() const { return (long long)(lcap + trcap) * (A + 1); }
  long long tiles() const { return (LT() + kTile - 1) / kTile; }
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
  q.cum_e = ints(d.N);
  q.e_marks = ints(d.ecap);
  q.e_item = ints(d.ecap);
  q.occ_sa = ints(d.ecap);
  q.occ_site = ints(d.ecap);
  q.occ_allele = ints(d.ecap);
  q.e_valid = bytes(d.ecap);
  q.ps_live = bytes(NS);
  q.nonvar = ints(d.R);
  q.cum_l = ints(NS);
  q.cum_t = ints(NS);
  q.l_marks = ints(d.lcap);
  q.t_marks = ints(d.trcap);
  q.lane_key = ints(LT);
  q.lane_site = ints(LT);
  q.lane_allele = ints(LT);
  q.keys_a = (u128*)take(LT * 16);
  q.keys_b = (u128*)take(LT * 16);
  q.keep = bytes(LT);
  q.hist = ints(kDigits * d.tiles());
  q.seg_start = ints(NS);
  q.seg_end = ints(NS);
  q.key_mat = ints(NS * d.kcap);
  q.row_cnt = ints(d.R);
  q.row_off = ints(d.R);
  q.row_cur = ints(d.R);
  q.bucket = ints(NS);
  q.first_occ = bytes(NS);
  q.n_sel = ints(d.R);
  q.agg = ints((long long)kAggs * d.grid);
  q.meta = ints(kMeta);
  if (p) {
    p->ps_ning = q.ps_ning; p->ing_parent = q.ing_parent;
    p->cum_e = q.cum_e; p->e_marks = q.e_marks; p->e_item = q.e_item;
    p->occ_sa = q.occ_sa; p->occ_site = q.occ_site;
    p->occ_allele = q.occ_allele; p->e_valid = q.e_valid;
    p->ps_live = q.ps_live; p->nonvar = q.nonvar; p->cum_l = q.cum_l;
    p->cum_t = q.cum_t; p->l_marks = q.l_marks; p->t_marks = q.t_marks;
    p->lane_key = q.lane_key; p->lane_site = q.lane_site;
    p->lane_allele = q.lane_allele; p->keys_a = q.keys_a;
    p->keys_b = q.keys_b; p->keep = q.keep; p->hist = q.hist;
    p->seg_start = q.seg_start; p->seg_end = q.seg_end;
    p->key_mat = q.key_mat; p->row_cnt = q.row_cnt; p->row_off = q.row_off;
    p->row_cur = q.row_cur; p->bucket = q.bucket;
    p->first_occ = q.first_occ; p->n_sel = q.n_sel; p->agg = q.agg;
    p->meta = q.meta;
  }
  return off + 16;
}

}  // namespace

// the cooperative grid of both launches on the current device (the
// smaller of the two kernels' co-resident blocks, at most kBlocksPerSm an
// SM); -(CUDA error) on failure
extern "C" int select_grid() {
  const int a = coop_grid(select_kernel, g_grid[0]);
  const int b = coop_grid(triples_kernel, g_grid[1]);
  if (a < 0) return a;
  if (b < 0) return b;
  return a < b ? a : b;
}

extern "C" long long select_scratch_bytes(int N, int R, int ecap, int lcap,
                                          int trcap, int A, int kcap,
                                          int grid) {
  const Dims d{N, R, ecap, lcap, trcap, A, kcap, grid};
  return carve(d, nullptr, nullptr);
}

extern "C" int select_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, select_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

// which = 0: the selection (select_kernel, stages up to ``stage``);
// which = 1: the triples (triples_kernel) after K9, on the same scratch
extern "C" int select_launch(
    int which, int N, const void* f_rid, const void* f_lo, const void* f_hi,
    const void* trav, const void* n_trav, const void* ing, const void* n_ing,
    const void* state_bad, int R, const void* row_ok,
    const void* row_first_raw, const void* sa, int sa_size,
    const void* ra_node, int n_ra, const void* nt_site,
    const void* nt_allele, const void* anc_len, const void* anc_site,
    const void* anc_allele, const void* base_site, int n_sites,
    int anc_stride, int A, int ecap, int lcap, int trcap, int kcap,
    int trip_cap, int stage, void* fallback, void* mapped, void* ps_row,
    void* ps_lo, void* ps_hi, void* ps_trav, void* ps_ntrav,
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
  const Dims d{N, R, ecap, lcap, trcap, A, kcap, grid};
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
  const void* fn = which == 0 ? (const void*)select_kernel
                              : (const void*)triples_kernel;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, 0,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
