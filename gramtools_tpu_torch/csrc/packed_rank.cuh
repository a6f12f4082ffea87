// Packed BWT rank, the per-row count shared by the kernels that read the
// bit-packed records of gramtools_tpu/ops/rank.py::build_packed_occ:
// packed_rank.cu (K1, four lanes a query, all four channels) and, through
// scan_common.cuh, wide_step.cu and locked_step.cu (inside the scan's
// cooperative kernels: a state's LF needs one channel and the DNA total,
// a newborn's one channel, so they count one or two nibble masks a code
// word instead of four).
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

// Count of code c among the first n nibbles of a code word (0 <= n <= 8).
__device__ __forceinline__ unsigned count_code(unsigned word, int n,
                                               unsigned c) {
  const unsigned pmask = n >= 8 ? kFull : ((1u << (4 * n)) - 1u);
  const unsigned y = ~(word ^ c * kRep);
  return __popc(y & (y >> 1) & (y >> 2) & (y >> 3) & kRep & pmask);
}

// Count of the DNA codes (1-4) among the first n nibbles of a code word:
// a nibble b3 b2 b1 b0 with b3 = 0 and either b2 = 0 and b1 | b0, or b2 = 1
// and b1 = b0 = 0 (the sum of count_word's four counts).
__device__ __forceinline__ unsigned count_dna(unsigned word, int n) {
  const unsigned pmask = n >= 8 ? kFull : ((1u << (4 * n)) - 1u);
  const unsigned b1 = word >> 1, b2 = word >> 2, b3 = word >> 3;
  const unsigned m = ~b3 & ((~b2 & (b1 | word)) | (b2 & ~b1 & ~word));
  return __popc(m & kRep & pmask);
}

// count_code and count_dna over one code vector's first n codes
__device__ __forceinline__ unsigned count_vec_code(uint4 w, int n,
                                                   unsigned c) {
  return count_code(w.x, clampn(n), c) + count_code(w.y, clampn(n - 8), c)
         + count_code(w.z, clampn(n - 16), c)
         + count_code(w.w, clampn(n - 24), c);
}

__device__ __forceinline__ unsigned count_vec_dna(uint4 w, int n) {
  return count_dna(w.x, clampn(n)) + count_dna(w.y, clampn(n - 8))
         + count_dna(w.z, clampn(n - 16)) + count_dna(w.w, clampn(n - 24));
}

// channel c (1-4) of a checkpoint vector; 0 for any other code
__device__ __forceinline__ int ckpt_chan(uint4 ck, int c) {
  return c == 1 ? (int)ck.x : c == 2 ? (int)ck.y : c == 3 ? (int)ck.z
                : c == 4 ? (int)ck.w : 0;
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

// rank of base c (0 for a c outside 1-4) and of all four DNA codes in
// bwt[0:r) by one thread: channel c of the row's rank and the sum of its
// four channels, with one or two nibble masks a code word instead of four
// (count_word's four counts summed are count_dna's). The
// whole record is loaded at once (a vector past the offset counts 0), so
// its loads are one round trip.
__device__ __forceinline__ int2 rank_chan_dna(const uint4* __restrict__ blocks,
                                              int r, int size, int c) {
  int off;
  const uint4* rec = record_of(blocks, r, size, &off);
  uint4 w[4];
  const uint4 ck = __ldg(rec);
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = __ldg(rec + kCodeVec0 + q);
  const bool dna = c >= 1 && c <= 4;
  unsigned nc = 0, nd = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (dna) nc += count_vec_code(w[q], off - 32 * q, (unsigned)c);
    nd += count_vec_dna(w[q], off - 32 * q);
  }
  return make_int2(ckpt_chan(ck, c) + (int)nc,
                   (int)(ck.x + ck.y + ck.z + ck.w) + (int)nd);
}

}  // namespace packed_rank_dev
