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
// ~200 launches; here the 6 wide steps of a buffer are one launch. It also
// takes the place of one more XLA function (scan_common.cuh): the fused
// program's 2-bit read unpack (search_jax_log.py::_unpack_reads2, K6),
// each base decoded where it is loaded from the packed rows, so the
// unpacked (steps, R) int32 matrix is never written. (The index-sharded
// path runs the same steps in gather rounds, sharded_step.cu.)
//
// A step's output is survivors then newborns then empty slots: a survivor
// of keep rank r goes to slot r, the newborn candidate of rank c (in (hit,
// outcome) order) to slot n_keep + c, or flags its read past the pool N;
// the slots from n_keep + n_cand on take (-1, 0, 0, 0); spilled states
// flag their read. Its two couplings across the pool: every rank (keep,
// hits, candidates) is a prefix over all earlier slots, and a newborn's
// slot needs n_keep, the survivors of the whole pool.
//
// Design: one grid sync a step, none inside it. A block owns tiles place,
// place + grid, ... of a step, its place ranking it by (its slot on its
// SM, its SM), so that the few busy tiles of a mid step (the pool's live
// front) run on distinct SMs, and takes them in order. A tile, on its own:
//   (a) reads its slots' carry, base, and for an active state the LF of
//       [lo, hi] (two occ rows: the dense table, or the packed records with
//       one nibble mask a code word for the base and one for the DNA total)
//       and its marker hits; keep, kept interval, cnt;
//   (b) publishes its payload (survivors, hits, last slot with hits and its
//       pref; tile 0's as its inclusive prefix) and, by its last warp, looks
//       back for the exclusive prefix (scan_common.cuh), while its other
//       warps work the first round of its hit pairs (tile_pair: a pair
//       needs only the tile's own prefix of hits; a tile whose first round
//       needs every warp works it before the look-back);
//   (c) writes its survivors at their keep rank into the output buffer and
//       flags its spilled states;
//   (d) works the rest of its pairs cut at G: each log record written in
//       place, the newborn candidates compacted in pair order; candidates
//       in (hit, outcome) order are in the slot order of their owners, so
//       the candidate rank is a chained scan in tile order too: the tile
//       looks back for it and copies its candidates to the step's stage at
//       their rank;
//   (e) the tile that closes the step writes the empty hit records
//       [min(total, G), G) x B (the last slot with hits' pref, slot 0's
//       when the step has none).
// Only the tiles below the pool's live front run: a step's output is
// live-packed (survivors, newborns, then empty slots), the incoming pool's
// front is its last read (found at the launch's start), and a slot without
// a read keeps, hits and places nothing (its flag goes to the dump slot).
// A tile waits only on tiles before it at the same step, each block takes
// its tiles in order, and the cooperative launch makes every block
// co-resident: the least tile not done waits on finished tiles only. Then
// one grid sync. The next step reads slot i as the survivor row i <
// n_keep, else the staged newborn i - n_keep < n_cand, else an empty slot
// (n_keep and n_cand from the closing tile's inclusive prefixes), so
// placement needs no pass of its own. Off each tile's chain, grid-stride
// loops flag the reads of the last step's dropped newborns (rank >= N -
// n_keep) and, at a phase's start, of the slots a shrinking resize cuts
// off (a resize is folded into the next step's reads: slots past the
// smaller pool read as empty). The launch copies the input flags in and
// zeroes every step's descriptors behind one grid sync, places the blocks
// and finds the incoming front behind a second, and packs the last step's
// carry into one buffer at the end: 2 + (steps) grid syncs, 8 for the 6
// wide steps of a buffer (the design before this one: 4 a step and 2 a
// resize, 25).
//
// What bounds it on the card: each step's slowest chain, not bytes. A
// block runs its tiles one after another; a tile's chain is its carry,
// the LF's two packed records and their count (ALU shared by an SM's three
// blocks at a step with more busy tiles than SMs), the first round of
// pairs (owner search, locus, outcome bounds, two records), the
// look-backs' L2 round trips, the stage copy; then the grid sync.
// Registers: 80 a thread (the cap for three blocks an SM; 48 bytes of
// stack), 6,268 bytes of static shared memory a block (nvcc -Xptxas -v,
// CUDA 12.8, sm_90a). ``ovf`` (R + 1,) gets the input flags (the last entry is the scan's dump
// slot) ORed with every flag the steps raise, and the dump slot wherever
// the twin's scatter routes an unflagged entry there. Built with
// -DK2_STAMPS, the kernel also records the global timer at the stages of
// each step of tiles 0, T / 2 and T - 1 and each tile's times and SM, and
// counts its grid syncs.
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
// blocks an SM: three (at most 85 registers a thread; with four, 64 and
// their spills cost more than the blocks gain) so that a warm step's 1,024
// tiles are ~2.6 a block
constexpr int kBlocksPerSM = 3;

// Stage timestamps, compiled in only with -DK2_STAMPS (a probe build,
// never the path's): the global timer at the stages of each step
// (scan_common.cuh), read back with wide_steps_stamps.
#ifdef K2_STAMPS
__device__ unsigned long long g_stamps[kStampSteps * 3 * kStampPts];
__device__ unsigned long long g_pub[kStampSteps * kPubTiles * kPubPts];
#define WSTAMP(k, who) \
  if (threadIdx.x == (who)) stamp_at(g_stamps, k, step, tile, T)
#define WPUB(k) \
  if (threadIdx.x == kLead) pub_at(g_pub, k, step, tile)
#define WPUB0(k) \
  if (threadIdx.x == 0) pub_at(g_pub, k, step, tile)
#else
#define WSTAMP(k, who)
#define WPUB(k)
#define WPUB0(k)
#endif

struct Params {
  Index x;
  const int* rid_in;          // (n_in,) carry in, never written
  const int* lo_in;
  const int* hi_in;
  const int* pref_in;
  const unsigned char* ovf_in;   // (R + 1,)
  int n_in;
  Reads rd;                   // (sum of steps, R) bases, int32 or packed
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
  int* scratch;               // scratch_ints(...)
  long long n_tiles_all;      // tiles over every step
};

// every step's tiles
__host__ __device__ inline long long step_tiles(int n_phases,
                                                const int* steps,
                                                const int* pool) {
  long long t = 0;
  for (int ph = 0; ph < n_phases; ++ph)
    t += (long long)steps[ph] * n_tiles(pool[ph]);
  return t;
}

// the stage (two buffers) and the compacted candidates, K int4 each, then
// every step's count words and payload descriptors, the blocks' slot
// counters (sm_slot) and the incoming pool's live front
__host__ __device__ inline long long scratch_ints(long long tiles, int K) {
  return 12LL * K + (long long)(kWordInts + 2 * kDescWords) * tiles + kMaxSm
         + 1;
}

// The carry a step reads: the last step's survivors (slots < nk) in src,
// its staged newborns (slots nk .. nk + nc - 1), empty slots past them or
// from lim on (the pool a resize shrank to). No slot from ``front`` on
// holds a read (a step's output is live-packed; the incoming pool's front
// is found at the launch's start).
struct VCarry {
  Carry src;
  int nk;
  const int4* stage;
  int nc;
  int lim;
  int front;
};

__device__ __forceinline__ int4 vread(const VCarry& v, int i) {
  if (i >= v.lim) return fill_row();
  if (i < v.nk) return carry_row(v.src, i);
  if (i - v.nk < v.nc) return v.stage[i - v.nk];
  return fill_row();
}

// the block's shared fields of the tile it works on
struct WideShared {
  PairTile pt;              // incl, hit, base, single (0), pref, first
  int rc[kThreads];         // each slot's read, clamped
  int warp_last[kWarps];    // the last slot with hits in each warp
  Payload excl, inc;        // the look-backs' broadcasts
  int c_excl;
};

// One tile of one wide step (port of _build_log_step) over N slots: its
// survivors into nxt, its candidates staged at their rank; pd, cd the
// step's payload descriptors and candidate count words.
template <class L>
__device__ void wide_tile(const Params& p, WideShared& ts, const VCarry& v,
                          Carry nxt, int4* stage, int4* cand, int N, int G,
                          int log_base, int tile, int T,
                          unsigned long long* pd, unsigned long long* cd,
                          int sent, int step) {
  const int R = p.R, B = p.x.B, x = threadIdx.x;
  const int i = tile * kThreads + x;
  const bool in = i < N;
  WSTAMP(0, 0);
  WPUB0(2);
  // (a) the carry, base, LF and marker hits of an active state
  const int4 c = in ? vread(v, i) : fill_row();
  const int rid = c.x, lo = c.y, hi = c.z, pref = c.w;
  const bool valid = rid >= 0;
  const int rc = clampi(rid, 0, R - 1);
  const int base = valid ? read_base<L>(p.rd, step, rc) : 0;
  const bool active = valid && base > 0;
  WSTAMP(9, 0);
  WPUB0(3);
  int klo = lo, khi = hi, mlo = 0, cnt = 0;
  bool alive = false;
  if (active) {
    const LF lf = lf_extend<L>(p.x, lo, hi, base, sent);
    klo = lf.nlo;
    khi = lf.nhi;
    mlo = lf.mlo;
    cnt = lf.mhi - lf.mlo;
    alive = lf.nlo <= lf.nhi;
  }
  const bool keep = (active && alive) || (valid && !active);
  WSTAMP(1, 0);
  WPUB0(4);
  const unsigned with_hits = __ballot_sync(kAll, cnt > 0);
  if ((x & 31) == 0)
    ts.warp_last[x >> 5] = with_hits ? x + 31 - __clz(with_hits) : -1;
  int n_keep, tile_cnt;
  const int keep_rank = block_scan(keep ? 1 : 0, &n_keep);
  const int excl = block_scan(cnt, &tile_cnt);
  ts.pt.incl[x] = excl + cnt;
  ts.pt.hit[x] = mlo;
  ts.pt.base[x] = base;
  ts.pt.single[x] = 0;
  ts.pt.pref[x] = pref;
  ts.rc[x] = rc;
  __syncthreads();
  WSTAMP(2, 0);

  // (b) the payload's chained scan by the last warp while the other warps
  // work the first round of pairs (a pair needs only the tile's own
  // prefix); a tile whose first round needs the last warp too works it
  // whole first
  const int n_pairs = tile_cnt * B;
  const bool heavy = n_pairs > kLead / pair_team(n_pairs);
  Payload agg;
  if (x >= kLead) {
    int last = -1;
    for (int w = 0; w < kWarps; ++w) last = max(last, ts.warp_last[w]);
    agg = Payload{n_keep, tile_cnt, last < 0 ? -1 : tile * kThreads + last,
                  last >= 0 ? ts.pt.pref[last]
                            : (tile == 0 ? ts.pt.pref[0] : 0)};
    if (x == kLead) {
      publish_payload(pd + (size_t)kDescWords * tile,
                      tile == 0 ? kInclusive : kAggregate, agg);
      WPUB(0);
    }
  }
  Pair early{};
  if (x < kLead ? n_pairs > 0 : heavy)
    early = early_pair<L>(p.x, ts.pt, n_pairs);
  if (x >= kLead) {
    const Payload e = tile > 0 ? payload_lookback(pd, tile) : no_payload();
    if (x == kLead) {
      ts.excl = e;
      ts.inc = tile > 0 ? combine(e, agg) : agg;
      if (tile > 0)
        publish_payload(pd + (size_t)kDescWords * tile, kInclusive, ts.inc);
    }
    WSTAMP(3, kLead);
  }
  __syncthreads();
  WSTAMP(4, 0);

  // (c) survivors at their keep rank, spilled states' flags
  const Payload e = ts.excl;
  if (in && keep) {
    const int d = e.n + keep_rank;                 // < n_keep <= N
    nxt.rid[d] = rid;
    nxt.lo[d] = klo;
    nxt.hi[d] = khi;
    nxt.pref[d] = pref;
  }
  const bool spilled = active && e.sum + excl + cnt > G && cnt > 0;
  if (spilled) p.ovf[rc] = 1;
  // the twin's scatter routes an unspilled slot's flag to the dump slot
  if (__syncthreads_or(in && !spilled) && x == 0) p.ovf[R] = 1;

  // (d) the pairs within the budget, then the candidates' rank
  const int g_end = tile_cnt > G - e.sum ? G : e.sum + tile_cnt;
  const int n_ok = g_end > e.sum ? (g_end - e.sum) * B : 0;
  const int k0 = n_ok > 0 ? e.sum * B : 0;
  const int n_c = staged_pairs<L>(p.x, ts.pt, ts.rc, n_pairs, n_ok,
                               log_base + k0, early, heavy, p.lp, p.le,
                               cand + k0);
  WSTAMP(5, 0);
  if (x >= kLead) {
    WPUB(1);
    const int ce = count_scan(cd, tile, n_c);
    if (x == kLead) ts.c_excl = ce;
  }
  __syncthreads();
  WSTAMP(6, 0);
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
  WSTAMP(7, 0);
  __syncthreads();                 // ts is the next tile's
}

template <class L>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
wide_steps_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ WideShared ts;
  const int R = p.R, B = p.x.B, C = p.C;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  int g_max = 1;
  for (int ph = 0; ph < p.n_phases; ++ph) g_max = max(g_max, p.hits[ph]);
  const int K = g_max * B;
  int4* stages = reinterpret_cast<int4*>(p.scratch);          // (2, K)
  int4* cand = stages + 2 * (size_t)K;                        // (K,)
  unsigned long long* words =
      reinterpret_cast<unsigned long long*>(cand + K);        // (tiles,)
  unsigned long long* descs = words + p.n_tiles_all;          // (tiles, 8)
  int* sm_cnt = reinterpret_cast<int*>(descs + p.n_tiles_all * kDescWords);
  int* front_in = sm_cnt + kMaxSm;                            // ()
  zero_syncs();

  // ---- the flags copied in, the descriptors and counters zeroed ----------
  for (int i = tid; i <= R; i += nthreads) p.ovf[i] = p.ovf_in[i];
  for (long long i = tid;
       i < p.n_tiles_all * (kWordInts + 2 * kDescWords) + kMaxSm + 1;
       i += nthreads)
    reinterpret_cast<int*>(words)[i] = 0;
  if (threadIdx.x < 5) ts.pt.first[threadIdx.x] = __ldg(p.x.sym_start +
                                                        threadIdx.x);
#ifdef K2_STAMPS
  for (int i = tid; i < kStampSteps * kPubTiles * kPubPts; i += nthreads)
    g_pub[i] = 0;
#endif
  const int sent = __ldg(p.x.sentinel_row);
  grid_sync(grid, 0);
  const int slot = sm_slot(sm_cnt);
  {                  // the incoming pool's live front: its last read + 1
    int f = 0;
    for (int i = tid; i < p.n_in; i += nthreads)
      if (__ldg(p.rid_in + i) >= 0) f = i + 1;
    f = __reduce_max_sync(kAll, f);
    if ((threadIdx.x & 31) == 0 && f > 0) atomicMax(front_in, f);
  }
  grid_sync(grid, 0);
  const int place = sm_place(sm_cnt, slot);

  VCarry v = {Carry{const_cast<int*>(p.rid_in), const_cast<int*>(p.lo_in),
                    const_cast<int*>(p.hi_in), const_cast<int*>(p.pref_in)},
              p.n_in, nullptr, 0, p.n_in, *front_in};
  int n_cur = p.n_in, step = 0, log_base = p.log_base, prev_n = 0, prev_gb = 0;
  long long tile0 = 0;
  // the last step's dropped newborns flag their read; its unflagged hit
  // pairs set the dump slot
  auto last_step_flags = [&]() {
    const int room = max(prev_n - v.nk, 0);
    for (int c = room + tid; c < v.nc; c += nthreads) p.ovf[v.stage[c].x] = 1;
    if (tid == 0 && prev_gb > max(v.nc - room, 0)) p.ovf[R] = 1;
  };
  for (int ph = 0; ph < p.n_phases; ++ph) {
    const int N = p.pool[ph], G = p.hits[ph];
    // _resize_pool, folded into the next reads: the cut slots flag their
    // read (an empty one the dump slot)
    for (int i = N + tid; i < n_cur; i += nthreads) {
      const int r = vread(v, i).x;
      if (r < 0) p.ovf[R] = 1;
      else if (r <= R) p.ovf[r] = 1;
    }
    v.lim = min(v.lim, N);
    n_cur = N;
    for (int s = 0; s < p.steps[ph]; ++s) {
      if (step > 0) last_step_flags();
      const Carry nxt = carry_at(p.carry, (step + 1) & 1, C);
      int4* stage = stages + (size_t)(step & 1) * K;
      unsigned long long* cd = words + tile0;
      unsigned long long* pd = descs + tile0 * kDescWords;
      // the tiles past the pool's live front hold no read: their slots
      // keep, hit and place nothing but send their flag to the dump slot
      // (tile 0 always runs: it closes a step with none)
      const int T = max(1, n_tiles(min(min(v.lim, N), v.front)));
      if (T * kThreads < N && blockIdx.x == 0 && threadIdx.x == 0)
        p.ovf[R] = 1;
      for (int tile = place; tile < T; tile += gridDim.x)
        wide_tile<L>(p, ts, v, nxt, stage, cand, N, G, log_base, tile, T,
                  pd, cd, sent, step);
      grid_sync(grid, 0);
#ifdef K2_STAMPS
      for (int tile = place; tile < T; tile += gridDim.x) WSTAMP(8, 0);
#endif
      // the step's totals, from the closing tile's inclusive prefixes
      const Payload tot = inclusive_payload(pd + (size_t)(T - 1) * kDescWords);
      const int n_cand = (int)(unsigned)cd[T - 1];
      v = VCarry{nxt, tot.n, stage, n_cand, N, min(N, tot.n + n_cand)};
      prev_n = N;
      prev_gb = G * B;
      tile0 += n_tiles(N);
      log_base += G * B;
      ++step;
    }
  }
  if (step > 0) last_step_flags();
  // the final carry packed into the buffer the wrapper returns
  const Carry out = carry_at(p.carry, step & 1, C);
  const bool in_place = v.src.rid == out.rid;
  for (int i = tid; i < n_cur; i += nthreads)
    if (!(in_place && i < v.nk && i < v.lim)) put_row(out, i, vread(v, i));
}

// the kernel's instance for int32 (0) or packed (1) reads
using Kernel = void (*)(const Params);
const Kernel kKernels[2] = {wide_steps_kernel<Layout<false>>,
                            wide_steps_kernel<Layout<true>>};

// co-resident blocks of each instance on each device, queried once
int g_max_blocks[2][kMaxDevices];

}  // namespace

extern "C" int wide_steps_max_phases() { return kMaxPhases; }

extern "C" long long wide_steps_scratch(int n_phases, const int* steps,
                                        const int* pool, int K) {
  return scratch_ints(step_tiles(n_phases, steps, pool), K);
}

#ifdef K2_STAMPS
// the grid syncs of the last launch (g_syncs) into host
extern "C" int wide_steps_syncs(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_syncs, sizeof(g_syncs));
}

// the stamps of the last launch, (kStampSteps, 3, kStampPts) u64, into host
extern "C" int wide_steps_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}

// every tile's publish times of the last launch, (kStampSteps, kPubTiles,
// kPubPts) u64, into host
extern "C" int wide_steps_pubs(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_pub, sizeof(g_pub));
}
#endif

// The registers a thread, local (spill) bytes a thread and static shared
// bytes a block of the kernel's instance for packed or int32 reads, into
// out[0:3]; returns the CUDA error.
extern "C" int wide_steps_attrs(int* out, int packed) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kKernels[packed ? 1 : 0]);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

// The grid a launch of the instance for packed or int32 reads will use for
// C slots: at most the blocks co-resident on the current device (queried
// once a device), no more than the largest pool's tiles. Returns -(CUDA
// error) on failure.
extern "C" int wide_steps_grid(int C, int packed) {
  const int slot = packed ? 1 : 0;
  return coop_grid(kKernels[slot], g_max_blocks[slot], n_tiles(C));
}

extern "C" int wide_steps(
    const void* rid_in, const void* lo_in, const void* hi_in,
    const void* pref_in, const void* ovf_in, int n_in,
    const void* reads, const void* packed, const void* row_len, int k,
    int total, int step0, int R, int n_phases, const int* steps,
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
  p.n_tiles_all = step_tiles(n_phases, steps, pool);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kKernels[packed != nullptr ? 1 : 0],
      dim3(grid), dim3(kThreads), args, 0,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
