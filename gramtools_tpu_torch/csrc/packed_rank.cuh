// Packed BWT rank, the per-row count shared by the kernels that read the
// bit-packed records of gramtools_tpu/ops/rank.py::build_packed_occ:
// packed_rank.cu (K1, four lanes a query) and, through scan_common.cuh,
// wide_step.cu and locked_step.cu (one thread a query, inside the scan's
// cooperative kernels).
//
// Record layout (uint32[24], six 16-byte vectors): words 0-3 the
// A/C/G/T checkpoints before the block, word 4 the marker checkpoint,
// words 5-7 reserved, words 8-23 the 128 4-bit symbol codes (nibble j of
// word 8+w is the code of bwt[128*blk + 8*w + j]; 0 sentinel/pad, 1-4
// DNA, 5 marker). rank_c(i) = ckpt[c] + the count of code c among the
// first i % 128 codes of record i / 128.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace packed_rank_dev {

constexpr int kBlock = 128;       // symbols per record
constexpr int kVecs = 6;          // 16-byte vectors per 96-byte record
constexpr int kCodeVec0 = 2;      // first code vector (words 8-11)
constexpr unsigned kRep = 0x11111111u;   // one bit per nibble
constexpr unsigned kFull = 0xFFFFFFFFu;

// Packed counts (A | C << 8 | G << 16 | T << 24) of the first n nibbles
// of one code word (0 <= n <= 8).
__device__ __forceinline__ unsigned count_word(unsigned word, int n) {
  const unsigned pmask = n >= 8 ? kFull : ((1u << (4 * n)) - 1u);
  unsigned packed = 0;
#pragma unroll
  for (int c = 1; c <= 4; ++c) {
    // nibble equality with code c: every bit of (word ^ c*rep) zero
    const unsigned y = ~(word ^ (unsigned)c * kRep);
    const unsigned m = y & (y >> 1) & (y >> 2) & (y >> 3) & kRep;
    packed += (unsigned)__popc(m & pmask) << (8 * (c - 1));
  }
  return packed;
}

__device__ __forceinline__ int clampn(int n) {
  return n < 0 ? 0 : (n > 8 ? 8 : n);
}

// Packed counts of one code vector (32 codes, words 8+4q .. 11+4q of the
// record) among its first n codes (n may be <= 0 or >= 32). Each of the
// four counts is at most 32, so the four vectors of a record sum without
// carrying across bytes (at most 128 each).
__device__ __forceinline__ unsigned count_vec(uint4 w, int n) {
  return count_word(w.x, clampn(n)) + count_word(w.y, clampn(n - 8))
         + count_word(w.z, clampn(n - 16)) + count_word(w.w, clampn(n - 24));
}

// The record of (clamped) row r and r's offset in it.
__device__ __forceinline__ const uint4* record_of(const uint4* blocks, int r,
                                                  int size, int* off) {
  // the scan passes -1 for invalid jump outcomes and relies on this
  // clamp (rank.py: jnp.clip(rows, 0, size))
  r = r < 0 ? 0 : (r > size ? size : r);
  *off = r % kBlock;
  return blocks + (size_t)(r / kBlock) * kVecs;
}

__device__ __forceinline__ int4 add_packed(uint4 ck, unsigned packed) {
  return make_int4((int)(ck.x + (packed & 0xFFu)),
                   (int)(ck.y + ((packed >> 8) & 0xFFu)),
                   (int)(ck.z + ((packed >> 16) & 0xFFu)),
                   (int)(ck.w + (packed >> 24)));
}

// rank of A, C, G, T in bwt[0:r) by one thread: the checkpoint vector
// and the code vectors that begin inside the prefix.
__device__ __forceinline__ int4 rank_row(const uint4* __restrict__ blocks,
                                         int r, int size) {
  int off;
  const uint4* rec = record_of(blocks, r, size, &off);
  const uint4 ck = __ldg(rec);
  unsigned packed = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (off > 32 * q) packed += count_vec(__ldg(rec + kCodeVec0 + q),
                                          off - 32 * q);
  }
  return add_packed(ck, packed);
}

}  // namespace packed_rank_dev
