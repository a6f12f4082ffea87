// Genealogy replay on Hopper (sm_90a): rebuild the traversed and
// traversing paths of every pool state from the scan's genealogy log.
//
// Replaces gramtools_tpu/mapping/record_jax.py::replay_device, which the
// TPU runs as XLA-lowered jnp (it is not a Pallas kernel): two
// data-dependent lax.while_loops, a level-by-level chase of all states'
// parent pointers (up to MAX_CHAIN levels, stopping when every chain has
// reached its seed) and a level-by-level root-to-leaf apply of the
// jump-table ops with masked scatters. In eager PyTorch each level's
// "any state still live?" test would be a host synchronisation. Every
// state's replay is independent of the others, so here one thread does
// its state's whole chain, with no synchronisation at all; the result is
// the one the lockstep levels give.
//
// Per state i (thread i):
//   p = alive ? f_pref : -1; chase p -> log_parent[p] recording
//       log_event[p] while p >= 0, at most max_chain events (kept in the
//       wrapper's (N, max_chain) scratch, since they are applied in
//       reverse);
//   bad = alive && p >= 0 (chain outran max_chain);
//   seed = clamp(-p - 1, 0, n_states - 1): a dead or bad state reads
//       seed 0, exactly as the jnp code's clamped gather does;
//   trav/ing = the seed's CSR paths (first min(max_path, tcap) slots, 0
//       past the path length); bad |= alive && path length > tcap;
//   for each chased event, root first, for each of its n_ops ops:
//       exit:  pop ing (if any), append (site, allele) to trav;
//       enter: push (site, ALLELE_UNKNOWN) on ing;
//       a write at slot tcap is dropped and sets bad, as mode="drop"
//       does; counts saturate at tcap.
//
// What bounds it on the card: dependent random gathers. A chain step
// reads one log_parent/log_event pair at a random place in the log (up
// to ~17 MB at the smoke shape), so a thread waits on up to max_chain
// serialised loads; production chains are a few events long (about the
// number of sites the read crossed). Each state then writes 2 x tcap x 8
// bytes of paths. The design keeps every thread independent and every
// write to its own rows, so no atomics and no block synchronisation;
// coalescing the path writes (a warp per state) is later work.
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers and PyTorch's current stream; the function returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kOpExit = 1;         // gramtools_tpu/mapping/jump_table.py
constexpr int kOpEnter = 2;
constexpr int kAlleleUnknown = -1;  // gramtools_tpu/prg/markers.py

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void replay_kernel(
    const int* __restrict__ f_pref, const unsigned char* __restrict__ alive,
    int n, const int* __restrict__ log_parent,
    const int* __restrict__ log_event, int lg,
    const int* __restrict__ k_nt, const int* __restrict__ k_ni,
    const int* __restrict__ k_toff, const int* __restrict__ k_ioff,
    const int2* __restrict__ t_flat, int t_len,
    const int2* __restrict__ i_flat, int i_len, int n_states, int p0c,
    const int* __restrict__ ops_kind, const int* __restrict__ ops_site,
    const int* __restrict__ ops_allele, int n_ev, int n_ops,
    int max_chain, int tcap, int* __restrict__ scratch,
    int2* __restrict__ trav, int* __restrict__ n_trav_out,
    int2* __restrict__ ing, int* __restrict__ n_ing_out,
    unsigned char* __restrict__ bad_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool al = alive[i] != 0;

  // chase to the seed
  int* events = scratch + (size_t)i * max_chain;
  int p = al ? f_pref[i] : -1;
  int depth = 0;
  while (p >= 0 && depth < max_chain) {
    const int pc = clampi(p, 0, lg - 1);
    events[depth++] = log_event[pc];
    p = log_parent[pc];
  }
  bool bad = al && p >= 0;

  // the seed's paths from the CSR tables
  const int seed = clampi(-p - 1, 0, n_states - 1);
  int nt = k_nt[seed];
  int ni = k_ni[seed];
  int2* tr = trav + (size_t)i * tcap;
  int2* ig = ing + (size_t)i * tcap;
  const int toff = k_toff[seed];
  const int ioff = k_ioff[seed];
  for (int s = 0; s < tcap; ++s) {
    int2 tv = make_int2(0, 0);
    int2 iv = make_int2(0, 0);
    if (s < p0c) {
      if (s < nt) tv = t_flat[clampi(toff + s, 0, t_len - 1)];
      if (s < ni) iv = i_flat[clampi(ioff + s, 0, i_len - 1)];
    }
    tr[s] = tv;
    ig[s] = iv;
  }
  bad = bad || (al && (nt > tcap || ni > tcap));

  // apply the chased events root to leaf
  for (int d = depth - 1; d >= 0; --d) {
    const int ev = events[d];
    const bool valid = ev >= 0;
    const int row = clampi(ev, 0, n_ev - 1) * n_ops;
    for (int o = 0; o < n_ops; ++o) {
      const int kind = valid ? ops_kind[row + o] : 0;
      if (kind == kOpExit) {
        if (ni > 0) --ni;
        if (nt < tcap) tr[nt] = make_int2(ops_site[row + o],
                                          ops_allele[row + o]);
        if (nt >= tcap) bad = true;
        nt = min(nt + 1, tcap);
      } else if (kind == kOpEnter) {
        if (ni < tcap) ig[ni] = make_int2(ops_site[row + o], kAlleleUnknown);
        if (ni >= tcap) bad = true;
        ni = min(ni + 1, tcap);
      }
    }
  }
  n_trav_out[i] = nt;
  n_ing_out[i] = ni;
  bad_out[i] = bad ? 1 : 0;
}

}  // namespace

extern "C" int replay(
    const void* f_pref, const void* alive, int n,
    const void* log_parent, const void* log_event, int lg,
    const void* k_nt, const void* k_ni, const void* k_toff,
    const void* k_ioff, const void* t_flat, int t_len, const void* i_flat,
    int i_len, int n_states, int p0c,
    const void* ops_kind, const void* ops_site, const void* ops_allele,
    int n_ev, int n_ops,
    int max_chain, int tcap, void* scratch,
    void* trav, void* n_trav, void* ing, void* n_ing, void* bad,
    void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int grid = (n + threads - 1) / threads;
  replay_kernel<<<grid, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(f_pref),
      static_cast<const unsigned char*>(alive), n,
      static_cast<const int*>(log_parent), static_cast<const int*>(log_event),
      lg, static_cast<const int*>(k_nt), static_cast<const int*>(k_ni),
      static_cast<const int*>(k_toff), static_cast<const int*>(k_ioff),
      static_cast<const int2*>(t_flat), t_len,
      static_cast<const int2*>(i_flat), i_len, n_states, p0c,
      static_cast<const int*>(ops_kind), static_cast<const int*>(ops_site),
      static_cast<const int*>(ops_allele), n_ev, n_ops, max_chain, tcap,
      static_cast<int*>(scratch), static_cast<int2*>(trav),
      static_cast<int*>(n_trav), static_cast<int2*>(ing),
      static_cast<int*>(n_ing), static_cast<unsigned char*>(bad));
  return (int)cudaGetLastError();
}
