// Goldilocks arithmetic and the tensor-core base DFT's shared pieces, for the
// kernels in this directory (base_dft.cu, base_dft_bf16.cu).
//
// p = 2^64 - 2^32 + 1; 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
//
// Both base-DFT kernels contract 8 digit planes of the data with 8 digit
// planes of the DFT matrix on the tensor cores and sum the 64 digit dots into
// 15 int32 buckets by weight 2^(8b), b = dc + wc. `fold_buckets` turns the
// buckets of one output into a field element, and the caller adds its
// per-column row (built by the host, poly/base_dft.py) mod p. The layouts of
// the operands in shared memory and of the host's weight table are the
// mma.sync fragment layouts, written out in `FragmentOrder` below.

#pragma once

#include <cstdint>

namespace goldilocks {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int kBuckets = 15;
// Added to each folded bucket to make it nonnegative; the host's row takes
// off kFoldBias * sum_{b<12} 2^(8b) (poly/base_dft.FOLD_BIAS).
constexpr int kFoldBias = 1 << 27;

// lo + hi * 2^64 mod p, canonical (2^64 = 2^32 - 1 and 2^96 = -1 mod p).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t hi_hi = hi >> 32;
  const uint64_t hi_lo = hi & kEps;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= kEps;  // borrow: the wrapped value is 2^64 too big
  const uint64_t t1 = hi_lo * kEps;
  uint64_t t2 = t0 + t1;
  // a carry out of 64 bits and t2 >= p both add 2^32 - 1 (t2 - p wraps to it)
  if (t2 < t1 || t2 >= kP) t2 += kEps;
  return t2;
}

// a - b mod p for canonical a and any b < p.
__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - kEps : d;
}

// a + b mod p for canonical a and b.
__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  // a carry out and s >= p both add 2^32 - 1; after a carry s < 2^64 - 2^33
  return (s < a || s >= kP) ? s + kEps : s;
}

// sum_{b<12} u[b] * 2^(8b) (mod p), canonical, for 0 <= u[b] < 2^28.
//
// The sum is below 2^118 and takes two u64 words. It is formed as S_0 +
// S_1 2^8 + S_2 2^16 + S_3 2^24 with S_s = u_s + u_{s+4} 2^32 + u_{s+8} 2^64,
// whose 32-bit limbs do not overlap: no third word and no per-bucket carry
// chain (the five-limb recombination of
// ethproof_tpu/poly/mxu_ntt.py::_recombine_buckets, shortened).
__device__ __forceinline__ uint64_t fold12(const uint32_t (&u)[12]) {
  uint64_t lo = (uint64_t)u[0] | ((uint64_t)u[4] << 32);
  uint64_t hi = u[8];
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    const uint64_t slo = (uint64_t)u[s] | ((uint64_t)u[s + 4] << 32);
    const uint64_t shi = u[s + 8];
    const uint64_t alo = slo << (8 * s);
    const uint64_t ahi = (shi << (8 * s)) | (slo >> (64 - 8 * s));
    lo += alo;
    hi += ahi + (lo < alo ? 1ull : 0ull);
  }
  return reduce128(lo, hi);
}

// sum_b bk[b] * 2^(8b) + kFoldBias * sum_{b<12} 2^(8b) (mod p), canonical.
// Buckets 12..14 fold first with 2^96 = -1: u_b = bk[b] - bk[b + 12] + bias
// for b < 3, u_b = bk[b] + bias for 3 <= b < 12. The callers keep each
// |bk[b] - bk[b + 12]| and each |bk[b]| below 2^27 (see the kernels' notes),
// so 0 < u_b < 2^28.
__device__ __forceinline__ uint64_t fold_buckets(const int (&bk)[kBuckets]) {
  uint32_t u[12];
#pragma unroll
  for (int b = 0; b < 12; ++b) {
    const int s = b < 3 ? bk[b] - bk[(b + 12) % kBuckets] : bk[b];
    u[b] = (uint32_t)(s + kFoldBias);
  }
  return fold12(u);
}

// FragmentOrder. mma.sync m16n8k32 (s8) and m16n8k16 (bf16) share one layout
// in 32-bit words (g = lane / 4, t = lane % 4; a word holds 4 s8 or 2 bf16
// consecutive contraction terms, the lower term in the lower bits):
//   A (16 rows x kstep terms, row-major): reg0 = row g, terms word t;
//     reg1 = row g + 8, word t; reg2 = row g, word t + 4; reg3 = row g + 8,
//     word t + 4;
//   B (kstep terms x 8 columns, column-major): reg0 = column g, word t;
//     reg1 = column g, word t + 4;
//   C (16 x 8, 32-bit): c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row
//     g + 8, the same columns.
// The kernels keep A in shared memory as one uint4 {reg0..reg3} per lane for
// each (16-row tile, contraction step, plane), and the host packs B as one
// uint4 {reg0, reg1 of plane 2q; reg0, reg1 of plane 2q + 1} per lane for
// each (8-column tile, contraction step, plane pair q): every operand load is
// one 16-byte access per lane, coalesced in device memory and free of bank
// conflicts in shared memory.

// The 4x4 byte transpose of four words: out[c] holds byte c of w0..w3, in
// that order (four consecutive terms of digit plane c).
__device__ __forceinline__ void byte_transpose(uint32_t w0, uint32_t w1, uint32_t w2,
                                               uint32_t w3, uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t u0 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t u1 = __byte_perm(w2, w3, 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(u0, u1, 0x5410);
  out[3] = __byte_perm(u0, u1, 0x7632);
}

}  // namespace goldilocks
