// Packed BWT rank on Hopper (sm_90a): rank of A, C, G, T in bwt[0:row)
// for every query row, read from the interleaved 96-byte records of
// gramtools_tpu/ops/rank.py::build_packed_occ.
//
// Replaces the TPU Pallas kernel gramtools_tpu/ops/rank.py::_rank_kernel
// (launched by _packed_rank_pallas through make_packed_occ_rows). On the
// TPU the record gather blocks[row // 128] is a separate XLA op that
// materialises an (M, 24) copy; here the kernel gathers the records
// itself, so that copy never exists (50 MB at M = 524,288).
//
// Record layout (uint32[24]): words 0-3 the A/C/G/T checkpoints before
// the block, word 4 the marker checkpoint, words 5-7 reserved, words
// 8-23 the 128 4-bit symbol codes (nibble j of word 8+w is the code of
// bwt[128*blk + 8*w + j]; 0 sentinel/pad, 1-4 DNA, 5 marker).
//
// What bounds it on the card: memory, not arithmetic. Each query reads
// its record at a random place in the table: one 32-byte sector for the
// checkpoints and up to two for the codes of its prefix, then does a few
// dozen integer ops. The scan's calls range from ~3,600 rows (the locked
// tail's wide states) to 524,288 (a warm step's whole pool); the table
// itself (3.6 MB at the 4.4 Mb graph) stays in the 50 MB L2, so the
// large calls are bound by the L2-to-SM traffic of the record sectors
// and by the load instructions that carry it, the small ones by launch
// and one chain of dependent loads.
//
// Design: four lanes per query. Lane q of a quad loads code words
// 8+4q .. 11+4q of the record as one aligned 16-byte load, only when
// they begin inside the prefix, and counts the four codes in its part;
// the quad's lanes therefore read 64 contiguous bytes of one record (two
// sectors, one request), where one thread per query issued up to 16
// scalar loads. The four counts (each at most 128) travel packed in
// one 32-bit word, 8 bits each, so two shuffles sum the quad; lane 0
// adds its 16-byte checkpoint load, issued before the shuffles, and the
// quads' lanes 0 write their 16-byte results side by side. Four times
// the threads of the earlier kernel are in flight to hide the latency
// of the random sector reads.
//
// The per-row count (count_word, count_vec, the clamp and the record
// address) lives in packed_rank.cuh, shared with the scan kernels.
//
// C interface for ctypes (no PyTorch headers): the wrapper passes raw
// device pointers and PyTorch's current stream; the function returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_rank.cuh"

namespace {

using namespace packed_rank_dev;

__global__ void packed_rank_kernel(const uint4* __restrict__ blocks,
                                   const int* __restrict__ rows,
                                   long long m, int size,
                                   int4* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t >> 2;      // query of this quad
  const int q = threadIdx.x & 3;   // lane in the quad
  const bool ok = i < m;
  int off;
  const uint4* rec = record_of(blocks, ok ? __ldg(rows + i) : 0, size, &off);
  const int n = off - 32 * q;      // prefix nibbles in this lane's part

  uint4 ck = make_uint4(0, 0, 0, 0);
  if (ok && q == 0) ck = __ldg(rec);
  unsigned packed = 0;
  if (ok && n > 0) packed = count_vec(__ldg(rec + kCodeVec0 + q), n);
  // quads never straddle a warp: every lane takes part in both shuffles
  packed += __shfl_xor_sync(kFull, packed, 1);
  packed += __shfl_xor_sync(kFull, packed, 2);
  if (ok && q == 0) out[i] = add_packed(ck, packed);
}

}  // namespace

extern "C" int packed_rank(const void* blocks, const void* rows,
                           long long m, int size, void* out,
                           void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  const long long grid = (4 * m + threads - 1) / threads;
  packed_rank_kernel<<<(unsigned)grid, threads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(blocks), static_cast<const int*>(rows),
      m, size, static_cast<int4*>(out));
  return (int)cudaGetLastError();
}
