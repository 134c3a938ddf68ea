// Exact Goldilocks DFT along the last axis in the bf16 encoding, on the
// tensor cores: out[r, k] = sum_i a[r, i] * W[k, i] mod p, p = 2^64 - 2^32 + 1,
// for a contiguous (rows, n) u64 array and n = 2^log_n <= 256. W[k, i] =
// w^(k*i) for the order-n root w (or its inverse); the inverse transform's 1/n
// scale is left to the caller.
//
// Replaces ethproof_tpu/poly/pallas_ntt.py::_dft_kernel (the TPU MXU kernel of
// the bf16 encoding). It computes the same function through the same chunked
// formulation and gives the same canonical bits; it is not a block-for-block
// copy (no 128-lane block-diagonal replication, no 2^15-element row blocks):
//   - every u64 is split into eight unsigned 8-bit chunks, exact in bf16; the
//     DFT matrix likewise (W chunk planes wc = 0..7, built by the host);
//   - each (data chunk dc, weight chunk wc) pair is one chain of
//     mma.sync.m16n8k16 bf16 x bf16 -> f32 over the n/16 contraction steps:
//     a product is < 2^16 and a whole dot < 255^2 * 256 < 2^24, so the f32
//     accumulator holds it exactly;
//   - each dot is converted to int32 on its own, BEFORE it is added into
//     bucket dc + wc (a bucket reaches 8 * 2^24 = 2^27, beyond f32's exact
//     integers but far inside int32);
//   - value = sum_b bucket_b * 2^(8b) < 2^140 is carried into three u64 words
//     and folded once with 2^128 = -2^32 (mod p), the algebra of
//     mxu_ntt._recombine_buckets.
// For n < 16 the contraction is zero-padded to 16; for n < 8 the 8-column
// output tile is partly empty.
//
// What bounds it on an H100: 2 * 64 * n operations per output element on the
// bf16 tensor cores against 16 bytes per element of device-memory traffic, so
// for n >= 16 the arithmetic is the bound on paper (989 TFLOP/s dense bf16).
// This first design is simple rather than fast: warp-level mma.sync instead
// of wgmma, no TMA and no pipelining, and each A fragment is rebuilt from the
// u64 data (read through the L1 cache) for every data chunk.
//
// Layout: grid (row blocks, n/8 output-column tiles), 4 warps per block. The
// block stages the eight weight chunks of its 8-column tile in shared memory
// ([wc][kk][i] bf16, rows padded by 8 bytes so the B-fragment loads of a warp
// hit 32 distinct banks). Each warp walks kTilesPerWarp tiles of 16 rows; for
// each it loops dc (outer), contraction step (middle) and wc (inner), with
// eight f32 accumulators live and fifteen int32 buckets per output element.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilesPerWarp = 8;
constexpr int kBuckets = 15;

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

// The bf16 bit pattern of the chunk (v >> sh) & 0xFF. A value below 256 has at
// most 8 significant bits, so the top half of its f32 bits is exact.
__device__ __forceinline__ uint32_t chunk_bf16(uint64_t v, int sh) {
  const float f = __uint2float_rn((uint32_t)(v >> sh) & 0xFFu);
  return __float_as_uint(f) >> 16;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (three u64 words) += x * 2^sh for x < 2^32 and sh < 128.
__device__ __forceinline__ void add_shifted(uint64_t (&acc)[3], uint64_t x, int sh) {
  const int w = sh >> 6;
  const int off = sh & 63;
  const uint64_t lo = x << off;
  const uint64_t hi = off ? x >> (64 - off) : 0ull;
  uint64_t s = acc[w] + lo;
  uint64_t carry = s < lo ? 1ull : 0ull;
  acc[w] = s;
  if (w == 0) {
    const uint64_t add1 = hi + carry;  // hi < 2^32: no overflow
    s = acc[1] + add1;
    acc[2] += (s < add1 ? 1ull : 0ull);
    acc[1] = s;
  } else {
    acc[2] += hi + carry;
  }
}

__global__ void __launch_bounds__(kThreads)
base_dft_bf16_kernel(const uint64_t* __restrict__ a, const uint16_t* __restrict__ wchunks,
                     uint64_t* __restrict__ out, long long rows, int log_n) {
  extern __shared__ uint32_t w_s[];  // [wc][kk][i / 2] bf16 pairs, row stride `stride`
  const int n = 1 << log_n;
  const int kpad = n < 16 ? 16 : n;  // contraction length, zero-padded to 16
  const int stride = kpad / 2 + 4;   // 32-bit words per (wc, kk) row
  const int k0 = blockIdx.y * 8;
  const int tid = threadIdx.x;

  // weight chunks of this block's 8 output columns: Wsm[wc][kk][i] =
  // chunk wc of W[k0 + kk, i] (zero past n in either index)
  for (int e = tid; e < 8 * 8 * (kpad / 2); e += kThreads) {
    const int ip = e % (kpad / 2);
    const int kk = (e / (kpad / 2)) & 7;
    const int wc = e / (8 * (kpad / 2));
    const int k = k0 + kk;
    const int i = 2 * ip;
    uint32_t lo = 0, hi = 0;
    if (k < n && i < n) {
      const uint16_t* row = wchunks + ((size_t)wc * n + k) * n;
      lo = row[i];
      hi = row[i + 1];  // n is even for log_n >= 1
    }
    w_s[(wc * 8 + kk) * stride + ip] = lo | (hi << 16);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // groupID
  const int t = lane & 3;   // threadID_in_group
  const int ksteps = kpad / 16;

  for (int it = 0; it < kTilesPerWarp; ++it) {
    const long long r0 =
        ((long long)blockIdx.x * kWarps * kTilesPerWarp + (long long)it * kWarps + warp) * 16;
    if (r0 >= rows) break;  // uniform across the warp
    const long long ra = r0 + g;      // fragment rows g and g + 8
    const long long rb = r0 + g + 8;
    const uint64_t* pa = a + ra * n;
    const uint64_t* pb = a + rb * n;
    const bool va = ra < rows;
    const bool vb = rb < rows;

    int bucket[kBuckets][4];
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) bucket[b][e] = 0;
    }

    // unrolled: the bucket index dc + wc must be a compile-time register
#pragma unroll
    for (int dc = 0; dc < 8; ++dc) {
      const int sh = 8 * dc;
      float acc[8][4];
#pragma unroll
      for (int wc = 0; wc < 8; ++wc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[wc][e] = 0.f;
      }
#pragma unroll 1
      for (int s = 0; s < ksteps; ++s) {
        // A fragment (16 rows x 16 terms of chunk plane dc): a0,a1 = row g,
        // terms 2t, 2t+1; a2,a3 = row g+8; a4..a7 = the same at terms +8
        const int i0 = 16 * s + 2 * t;
        uint32_t afr[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + 8 * half;
          const bool in = i < n;
          const uint64_t x0 = (va && in) ? __ldg(pa + i) : 0ull;
          const uint64_t x1 = (va && in) ? __ldg(pa + i + 1) : 0ull;
          const uint64_t y0 = (vb && in) ? __ldg(pb + i) : 0ull;
          const uint64_t y1 = (vb && in) ? __ldg(pb + i + 1) : 0ull;
          afr[2 * half] = chunk_bf16(x0, sh) | (chunk_bf16(x1, sh) << 16);
          afr[2 * half + 1] = chunk_bf16(y0, sh) | (chunk_bf16(y1, sh) << 16);
        }
#pragma unroll
        for (int wc = 0; wc < 8; ++wc) {
          // B fragment (16 terms x 8 columns of chunk wc): b0,b1 = terms
          // 2t, 2t+1 of column g; b2,b3 = terms 2t+8, 2t+9
          const uint32_t* wrow = w_s + (wc * 8 + g) * stride + 8 * s + t;
          mma_bf16(acc[wc], afr, wrow[0], wrow[4]);
        }
      }
      // each dot to int32 on its own (exact: < 2^24), then into its bucket
#pragma unroll
      for (int wc = 0; wc < 8; ++wc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) bucket[dc + wc][e] += __float2int_rn(acc[wc][e]);
      }
    }

    // C fragment: c0,c1 = row g, columns 2t, 2t+1; c2,c3 = row g+8
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = e < 2 ? ra : rb;
      const int k = k0 + 2 * t + (e & 1);
      if (r >= rows || k >= n) continue;
      uint64_t v[3] = {0ull, 0ull, 0ull};
#pragma unroll
      for (int b = 0; b < kBuckets; ++b) add_shifted(v, (uint64_t)(uint32_t)bucket[b][e], 8 * b);
      // v < 2^140: v[2] < 2^12, and 2^128 = -2^32 (mod p)
      out[r * n + k] = sub_mod(reduce128(v[0], v[1]), v[2] << 32);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `wchunks` is the (8, n, n) bf16 table of the DFT matrix's 8-bit chunks,
// [wc][k][i].
extern "C" int ethproof_base_dft_bf16(const void* a, const void* wchunks, void* out,
                                      long long rows, int log_n, void* stream) {
  if (log_n < 1 || log_n > 8 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int n = 1 << log_n;
  const int kpad = n < 16 ? 16 : n;
  const size_t smem = (size_t)8 * 8 * (kpad / 2 + 4) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      base_dft_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = 16LL * kWarps * kTilesPerWarp;
  const dim3 grid((unsigned)((rows + rows_per_block - 1) / rows_per_block),
                  (unsigned)(n < 8 ? 1 : n / 8));
  base_dft_bf16_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)a, (const uint16_t*)wchunks, (uint64_t*)out, rows, log_n);
  return (int)cudaGetLastError();
}
