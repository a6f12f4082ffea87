// Per-base coverage recorder on Hopper (sm_90a): from the selected
// states of one buffer to the +1/-1 boundary adds in cov_diff, in four
// kernels and no sort.
//
// Replaces gramtools_tpu/mapping/record_jax.py::_record_per_base_device
// (XLA-lowered jnp on the TPU, not Pallas): the occurrence expansion of
// the selected states into walk lanes (_expand_budget), the walk loop
// (make_body under a lax.while_loop), the sort of the emissions by
// (row, node) with a segment min/max envelope, and the diff-array adds.
//
//   per_base_init_kernel    the hash table emptied, fallback copied to
//                           the output, counters zeroed, and each tile
//                           of 1024 states' walk widths summed;
//   per_base_expand_kernel  each tile's exclusive prefix (the sums of
//                           the tiles before it) and a block scan: cum,
//                           the inclusive prefix of the widths; a state
//                           with lanes past wcap flags its row FB_WALK;
//   per_base_walk_kernel    one thread a lane: the lane finds its state
//                           by binary search in cum, gathers its start
//                           (SA -> PRG position -> node, offset) and
//                           walks; emissions are staged in the block's
//                           shared memory, then the block takes its
//                           place in the emission count with ONE global
//                           atomic and folds them into an open-
//                           addressing table keyed by (row, node):
//                           atomicCAS on the key, atomicMin on start,
//                           atomicMax on end;
//   per_base_apply_kernel   spill = more emissions than emitcap or a
//                           lane past max_iter. On spill every row with
//                           a selected state takes FB_EMIT and nothing
//                           is added (every emitting row is such a row);
//                           otherwise each table entry whose row has no
//                           fallback bit and whose node has coverage
//                           adds +1 at cov_start + min and -1 at
//                           cov_start + max + 1 (slot cov_size is a
//                           legitimate end boundary).
//
// Why this equals the sorted envelope: a (row, node) group's min start
// and max end do not depend on the order of its emissions, and the
// int32 adds commute. The JAX function keeps only the first emitcap
// emissions, but when there are more it flags every emitting row, so
// none of them is added; the table takes at most emitcap emissions (the
// ones whose place in the count is below emitcap) into 2 * emitcap or
// more slots, so a probe always finds room. (A table of just over
// emitcap slots, up to 3/4 full, makes the probes longer and the
// function slower.)
//
// Walk per lane, the loop body of make_body: the first iteration
// consumes the start node; later ones die if no read bases remain or
// the node has no out-edge, else move along out-edge 0 or, at a bubble
// entry (more than one out-edge), along the edge named by the allele of
// the next traversed locus (trav_idx counts down ps_trav[state]); then
// consume min(seq_len, remaining) bases. A consumed in-bubble node with
// sequence emits (row, node, start, end); a partial occurrence (offset
// > 0 in its SA interval) stops once it has returned to a bubble.
//
// What bounds it on the card: the walk is a chain of dependent loads
// (node row -> next node row), 16-51 iterations a lane on the
// M. tuberculosis workload, and a warp runs as long as its longest
// lane. The design cuts the chain to one load an iteration: nt_step's
// 32-byte row carries a node's first two successors beside its
// (n_edges, seq_len, in_bubble, edge_off), so only an entry whose
// allele is past the second edge reads nt_edges; the next allele of the
// lane's path is loaded ahead of the entry that needs it. No emission
// takes a round trip to a global atomic. The bytes it must move (~5 MB
// a buffer) take ~1.5 us at HBM rate.
//
// Precondition (held by the caller): a selected state's interval is not
// empty (hi >= lo), so cum never decreases and the binary search finds
// the state of the reference's prefix-max expansion.
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers, the scratch it allocated and PyTorch's current
// stream; the function returns the first cudaGetLastError() after the
// four launches, 0 on success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFbWalk = 256;      // search_log_host.FB_WALK
constexpr int kFbEmit = 512;      // search_log_host.FB_EMIT
constexpr int kTileThreads = 256;
constexpr int kTileItems = 4;
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kWalkThreads = 128;
constexpr int kStage = 2048;      // staged emissions a walk block (32 KB)
constexpr int kClearBlocks = 264;
constexpr unsigned long long kEmpty = ~0ull;

enum { kCursor = 0, kOverrun = 1, kCounters = 2 };

struct __align__(16) Slot {
  unsigned long long key;         // row << 32 | node, kEmpty when free
  int lo;                         // min start
  int hi;                         // max end
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int width(const unsigned char* selected,
                                     const int* lo, const int* hi, int i) {
  // int32 wrap-around, as the reference's int32 cumsum
  return selected[i] ? (int)((unsigned)hi[i] - (unsigned)lo[i] + 1u) : 0;
}

// Sum of v over the block (every thread gets it); scratch >= 32 ints.
__device__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1)
    v = (int)((unsigned)v + (unsigned)__shfl_down_sync(0xffffffffu, v, d));
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
    total = (int)((unsigned)total + (unsigned)scratch[w]);
  return total;
}

__global__ void per_base_init_kernel(
    int n_items, const unsigned char* __restrict__ selected,
    const int* __restrict__ lo, const int* __restrict__ hi,
    int* __restrict__ tile_sum, int rows,
    const int* __restrict__ fallback_in, int* __restrict__ fallback_out,
    Slot* __restrict__ table, int table_size, int* __restrict__ counters) {
  __shared__ int scratch[32];
  const int n_tiles = (n_items + kTile - 1) / kTile;
  if ((int)blockIdx.x < n_tiles) {
    const int base = blockIdx.x * kTile;
    int s = 0;
    for (int k = threadIdx.x; k < kTile; k += blockDim.x)
      if (base + k < n_items)
        s = (int)((unsigned)s + (unsigned)width(selected, lo, hi, base + k));
    s = block_sum(s, scratch);
    if (threadIdx.x == 0) tile_sum[blockIdx.x] = s;
  }
  const int stride = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const Slot empty = {kEmpty, 0x7fffffff, -1};
  for (int j = t; j < table_size; j += stride) table[j] = empty;
  for (int r = t; r < rows; r += stride) fallback_out[r] = fallback_in[r];
  if (t < kCounters) counters[t] = 0;
}

__global__ void __launch_bounds__(kTileThreads) per_base_expand_kernel(
    int n_items, const unsigned char* __restrict__ selected,
    const int* __restrict__ lo, const int* __restrict__ hi,
    const int* __restrict__ ps_row, const int* __restrict__ tile_sum,
    int wcap, int rows, int* __restrict__ cum,
    int* __restrict__ fallback_out) {
  __shared__ int scratch[32];
  __shared__ int warp_incl[kTileThreads / 32];
  // the sums of the tiles before this one
  int before = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += blockDim.x)
    before = (int)((unsigned)before + (unsigned)tile_sum[b]);
  before = block_sum(before, scratch);

  const int first = blockIdx.x * kTile + threadIdx.x * kTileItems;
  int w[kTileItems];
  unsigned run = 0;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    w[k] = first + k < n_items ? width(selected, lo, hi, first + k) : 0;
    run += (unsigned)w[k];
  }
  // inclusive scan of the thread totals across the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = run;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_incl[warp] = (int)incl;
  __syncthreads();
  unsigned warp_before = 0;
  for (int v = 0; v < warp; ++v) warp_before += (unsigned)warp_incl[v];
  unsigned c = (unsigned)before + warp_before + (incl - run);
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int i = first + k;
    if (i >= n_items) break;
    c += (unsigned)w[k];
    cum[i] = (int)c;
    if (w[k] > 0 && (int)c > wcap) {
      const int r = ps_row[i];
      if (r >= 0 && r < rows) atomicOr(fallback_out + r, kFbWalk);
    }
  }
}

__device__ __forceinline__ unsigned hash_key(unsigned long long key) {
  unsigned h = (unsigned)(key >> 32) * 0x9E3779B1u ^ (unsigned)key * 0x85EBCA77u;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h;
}

// Fold one emission into the (row, node) table; the caller admits at
// most emitcap emissions into table_size >= 2 * emitcap slots, so the
// probe ends at a free slot or the key's own.
__device__ void table_insert(Slot* table, int table_size, int4 e,
                             int* overrun) {
  const unsigned long long key =
      ((unsigned long long)(unsigned)e.x << 32) | (unsigned)e.y;
  unsigned h = hash_key(key) & (unsigned)(table_size - 1);
  for (int probe = 0; probe < table_size; ++probe) {
    const unsigned long long prev = atomicCAS(&table[h].key, kEmpty, key);
    if (prev == kEmpty || prev == key) {
      atomicMin(&table[h].lo, e.z);
      atomicMax(&table[h].hi, e.w);
      return;
    }
    h = (h + 1) & (unsigned)(table_size - 1);
  }
  atomicExch(overrun, 1);             // unreachable by the bound above
}

__global__ void __launch_bounds__(kWalkThreads) per_base_walk_kernel(
    int n_items, const int* __restrict__ cum, int wcap,
    const int* __restrict__ ps_lo, const int* __restrict__ ps_row,
    const int* __restrict__ ps_ntrav, const int2* __restrict__ ps_trav,
    int tcap, const int* __restrict__ sa, int sa_size,
    const int* __restrict__ ra_node, const int* __restrict__ ra_offset,
    int n_ra, const int* __restrict__ row_len, int rows,
    const int4* __restrict__ nt_step, const int* __restrict__ nt_edges,
    int n_edges, int max_iter, int emitcap, Slot* __restrict__ table,
    int table_size, int* __restrict__ counters) {
  __shared__ int4 stage[kStage];
  __shared__ int n_staged, block_base;
  const int total = cum[n_items - 1];
  const int n_lanes = min(total, wcap);
  if ((int)(blockIdx.x * blockDim.x) >= n_lanes) return;   // whole block
  if (threadIdx.x == 0) n_staged = 0;
  __syncthreads();

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n_lanes) {
    // the lane's state: the first with cum > g
    int a = 0, b = n_items - 1;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (cum[m] > g) b = m; else a = m + 1;
    }
    const int item = a;
    const int off = g - (item > 0 ? cum[item - 1] : 0);
    const int occ = clampi(ps_lo[item] + off, 0, sa_size - 1);
    const int prg = clampi(sa[occ], 0, n_ra - 1);
    const int row = clampi(ps_row[item], 0, rows - 1);
    int cur = ra_node[prg];
    int start = ra_offset[prg];
    int remaining = row_len[row];
    int trav_idx = ps_ntrav[item];
    const bool is_full = off == 0;
    const int2* trav = ps_trav + (size_t)item * tcap;
    int next_allele = trav[clampi(trav_idx - 1, 0, tcap - 1)].y;
    int4 node = nt_step[2 * cur];       // n_edges, seq_len, in_bubble, edge_off
    int4 succ = nt_step[2 * cur + 1];   // edge 0's and edge 1's target
    bool first = true;
    for (int it = 0;; ++it) {
      if (it >= max_iter) {
        atomicExch(counters + kOverrun, 1);
        break;
      }
      bool entry = false;
      if (!first) {
        if (remaining <= 0 || node.x == 0) break;       // dead
        entry = node.x > 1;
        int choice = 0;
        if (entry) {
          --trav_idx;
          choice = next_allele;
          next_allele = trav[clampi(trav_idx - 1, 0, tcap - 1)].y;
        }
        cur = choice == 0 ? succ.x
            : choice == 1 ? succ.y
            : nt_edges[clampi(node.w + choice, 0, n_edges - 1)];
        start = 0;
        node = nt_step[2 * cur];
        succ = nt_step[2 * cur + 1];
      }
      const int seq_len = node.y;
      const bool in_bubble = node.z > 0;
      const bool has_seq = seq_len > 0;
      const int end = has_seq ? min(seq_len - 1, start + remaining - 1) : 0;
      if (has_seq) remaining -= end - start + 1;
      if (has_seq && in_bubble) {
        // one shared-memory atomic for the warp's emitting lanes
        cg::coalesced_group grp = cg::coalesced_threads();
        int pos = 0;
        const int rank = (int)grp.thread_rank();
        if (rank == 0) pos = atomicAdd(&n_staged, (int)grp.size());
        pos = grp.shfl(pos, 0) + rank;
        const int4 e = make_int4(row, cur, start, end);
        if (pos < kStage) {
          stage[pos] = e;
        } else {                        // a full stage: straight to the table
          if (atomicAdd(counters + kCursor, 1) < emitcap)
            table_insert(table, table_size, e, counters + kOverrun);
        }
      }
      const bool returned = first ? in_bubble : (in_bubble || entry);
      first = false;
      if (!is_full && returned) break;
    }
  }
  __syncthreads();
  const int n = min(n_staged, kStage);
  if (threadIdx.x == 0) block_base = atomicAdd(counters + kCursor, n);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    if (block_base + j < emitcap)
      table_insert(table, table_size, stage[j], counters + kOverrun);
}

__global__ void per_base_apply_kernel(
    const Slot* __restrict__ table, int table_size,
    const int* __restrict__ counters, int emitcap,
    const int* __restrict__ nt_cov_start, int cov_len,
    int* __restrict__ cov_diff, int n_items,
    const unsigned char* __restrict__ selected,
    const int* __restrict__ ps_row, int rows,
    int* __restrict__ fallback_out) {
  const bool spill = counters[kCursor] > emitcap || counters[kOverrun] != 0;
  const int stride = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (spill) {
    for (int i = t; i < n_items; i += stride) {
      const int r = ps_row[i];
      if (selected[i] && r >= 0 && r < rows)
        atomicOr(fallback_out + r, kFbEmit);
    }
    return;
  }
  for (int j = t; j < table_size; j += stride) {
    const Slot s = table[j];
    if (s.key == kEmpty) continue;
    const int row = (int)(s.key >> 32);
    if (fallback_out[row] != 0) continue;
    const int covs = nt_cov_start[(int)(unsigned)s.key];
    if (covs < 0) continue;
    const int a = covs + s.lo, b = covs + s.hi + 1;
    if (a >= 0 && a < cov_len) atomicAdd(cov_diff + a, 1);
    if (b >= 0 && b < cov_len) atomicAdd(cov_diff + b, -1);
  }
}

}  // namespace

extern "C" int per_base(
    int n_items, const void* selected, const void* ps_lo, const void* ps_hi,
    const void* ps_row, const void* ps_ntrav, const void* ps_trav, int tcap,
    const void* sa, int sa_size, const void* ra_node, const void* ra_offset,
    int n_ra, const void* row_len, int rows, const void* fallback_in,
    const void* nt_step, const void* nt_edges, int n_edges,
    const void* nt_cov_start, int cov_len, void* cov_diff, int wcap,
    int emitcap, int max_iter, void* fallback_out, void* cum,
    void* tile_sum, void* table, int table_size, void* counters,
    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* sel = static_cast<const unsigned char*>(selected);
  const auto* lo = static_cast<const int*>(ps_lo);
  const auto* row = static_cast<const int*>(ps_row);
  auto* fb = static_cast<int*>(fallback_out);
  auto* tab = static_cast<Slot*>(table);
  auto* cnt = static_cast<int*>(counters);
  const int n_tiles = (n_items + kTile - 1) / kTile;
  const int init_blocks = n_tiles > kClearBlocks ? n_tiles : kClearBlocks;
  per_base_init_kernel<<<init_blocks, kTileThreads, 0, s>>>(
      n_items, sel, lo, static_cast<const int*>(ps_hi),
      static_cast<int*>(tile_sum), rows,
      static_cast<const int*>(fallback_in), fb, tab, table_size, cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  per_base_expand_kernel<<<n_tiles, kTileThreads, 0, s>>>(
      n_items, sel, lo, static_cast<const int*>(ps_hi), row,
      static_cast<const int*>(tile_sum), wcap, rows, static_cast<int*>(cum),
      fb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  per_base_walk_kernel<<<(wcap + kWalkThreads - 1) / kWalkThreads,
                         kWalkThreads, 0, s>>>(
      n_items, static_cast<const int*>(cum), wcap, lo, row,
      static_cast<const int*>(ps_ntrav), static_cast<const int2*>(ps_trav),
      tcap, static_cast<const int*>(sa), sa_size,
      static_cast<const int*>(ra_node), static_cast<const int*>(ra_offset),
      n_ra, static_cast<const int*>(row_len), rows,
      static_cast<const int4*>(nt_step), static_cast<const int*>(nt_edges),
      n_edges, max_iter, emitcap, tab, table_size, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  per_base_apply_kernel<<<kClearBlocks, kTileThreads, 0, s>>>(
      tab, table_size, cnt, emitcap,
      static_cast<const int*>(nt_cov_start), cov_len,
      static_cast<int*>(cov_diff), n_items, sel, row, rows, fb);
  return (int)cudaGetLastError();
}
