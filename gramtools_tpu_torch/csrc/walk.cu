// Per-base coverage walk on Hopper (sm_90a): walk every selected
// state's SA occurrence through the coverage graph and emit the
// (row, node, start, end) ranges it covers inside bubbles.
//
// Replaces the walk loop of
// gramtools_tpu/mapping/record_jax.py::_record_per_base_device (make_body
// under a lax.while_loop), which the TPU runs as XLA-lowered jnp (it is
// not a Pallas kernel). The loop has no static bound: it runs until every
// lane is inactive, ~16-51 iterations a buffer on the M. tuberculosis
// workload. In eager PyTorch each iteration's "any lane active?" test
// would be a host synchronisation; here one thread runs its lane's loop
// to the end, so the launch needs none.
//
// Per lane (thread), the loop body of make_body, unchanged:
//   first iteration: consume the start node from (cur0, start0);
//   later iterations: die if no read bases remain or the node has no
//   out-edge; otherwise move along out-edge 0, or, at a bubble entry
//   (more than one out-edge), along the edge named by the allele of the
//   next traversed locus (trav_idx counts down ps_trav[w_item]); then
//   consume min(seq_len, remaining) bases of the new node;
//   a consumed in-bubble node with sequence emits (row, node, start, end)
//   through an atomic cursor; a partial occurrence (full == 0) stops
//   once it has returned to a bubble.
// Emissions past emitcap are dropped; the wrapper reads the cursor and
// marks a spill when it passed emitcap. A lane that outruns max_iter
// iterations (impossible on the acyclic coverage graph, where every
// iteration moves one node) stops and raises the overrun flag, which
// the wrapper also reports as a spill, so no lane can spin forever.
//
// What bounds it on the card: dependent random gathers, one 16-byte
// nt_walk row and one nt_edges word per iteration and lane, plus one
// ps_trav read per bubble entry; lanes diverge in length, so a warp runs
// as long as its longest lane. The design gathers each node's four
// fields (n_edges, seq_len, in_bubble, edge_off) as one int4 and reads
// ps_trav through w_item instead of a materialised per-lane copy of the
// path. The emission order depends on the atomics; the caller's stable
// (row, node) sort and segment min/max do not depend on it.
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers and PyTorch's current stream; the function returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void walk_kernel(
    int lanes, const unsigned char* __restrict__ valid,
    const int* __restrict__ cur0, const int* __restrict__ start0,
    const int* __restrict__ remaining0, const int* __restrict__ trav_idx0,
    const int* __restrict__ w_item, const int* __restrict__ read_of,
    const unsigned char* __restrict__ full,
    const int2* __restrict__ ps_trav, int tcap,
    const int4* __restrict__ nt_walk, const int* __restrict__ nt_edges,
    int n_edges, int max_iter, int emitcap, int4* __restrict__ emits,
    int* __restrict__ cursor, int* __restrict__ overrun) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes || !valid[i]) return;
  int cur = cur0[i];
  int start = start0[i];
  int remaining = remaining0[i];
  int trav_idx = trav_idx0[i];
  const int row = read_of[i];
  const bool is_full = full[i] != 0;
  const int2* trav = ps_trav + (size_t)w_item[i] * tcap;
  int4 wrow = nt_walk[cur];          // (n_edges, seq_len, in_bubble, edge_off)
  bool first = true;
  for (int it = 0;; ++it) {
    if (it >= max_iter) {
      atomicExch(overrun, 1);
      return;
    }
    bool entry = false;
    if (!first) {
      if (remaining <= 0 || wrow.x == 0) return;     // dead
      entry = wrow.x > 1;
      int choice = 0;
      if (entry) {
        --trav_idx;
        choice = trav[clampi(trav_idx, 0, tcap - 1)].y;
      }
      cur = nt_edges[clampi(wrow.w + choice, 0, n_edges - 1)];
      start = 0;
      wrow = nt_walk[cur];
    }
    const int seq_len = wrow.y;
    const bool in_bubble = wrow.z > 0;
    const bool has_seq = seq_len > 0;
    const int end = has_seq ? min(seq_len - 1, start + remaining - 1) : 0;
    if (has_seq) remaining -= end - start + 1;
    if (has_seq && in_bubble) {
      const int slot = atomicAdd(cursor, 1);
      if (slot < emitcap) emits[slot] = make_int4(row, cur, start, end);
    }
    const bool returned = first ? in_bubble : (in_bubble || entry);
    first = false;
    if (!is_full && returned) return;
  }
}

}  // namespace

extern "C" int walk(int lanes, const void* valid, const void* cur0,
                    const void* start0, const void* remaining0,
                    const void* trav_idx0, const void* w_item,
                    const void* read_of, const void* full,
                    const void* ps_trav, int tcap, const void* nt_walk,
                    const void* nt_edges, int n_edges, int max_iter,
                    int emitcap, void* emits, void* cursor, void* overrun,
                    void* stream) {
  if (lanes <= 0) return 0;
  const int threads = 128;
  const int grid = (lanes + threads - 1) / threads;
  walk_kernel<<<grid, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      lanes, static_cast<const unsigned char*>(valid),
      static_cast<const int*>(cur0), static_cast<const int*>(start0),
      static_cast<const int*>(remaining0), static_cast<const int*>(trav_idx0),
      static_cast<const int*>(w_item), static_cast<const int*>(read_of),
      static_cast<const unsigned char*>(full),
      static_cast<const int2*>(ps_trav), tcap,
      static_cast<const int4*>(nt_walk), static_cast<const int*>(nt_edges),
      n_edges, max_iter, emitcap, static_cast<int4*>(emits),
      static_cast<int*>(cursor), static_cast<int*>(overrun));
  return (int)cudaGetLastError();
}
