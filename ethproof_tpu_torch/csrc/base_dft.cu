// Exact Goldilocks DFT along the last axis: out[r, k] = sum_i a[r, i] * W[k, i]
// mod p, p = 2^64 - 2^32 + 1, for a contiguous (rows, n) u64 array and
// n = 2^log_n <= 256. W[k, i] = w^(k*i) for the order-n root w (or its
// inverse); the inverse transform's 1/n scale is left to the caller.
//
// Replaces ethproof_tpu/poly/pallas_ntt.py::_dft_kernel_i8 (the TPU MXU
// kernel: int8 digit planes, 15 int32 buckets, 5-limb recombination). It
// computes the same function and gives the same canonical bits; it is not a
// block-for-block copy. The 128-lane block-diagonal replication, the
// 2^15-element row blocks and the VMEM-resident weight table are TPU
// artefacts and are not carried over.
//
// What bounds it on an H100: the n 64x64-bit multiply-accumulates per output
// element run on the 32-bit integer multiplier (a 64x64->128 product is about
// eight IMADs), so for n >= 16 the kernel is bound by integer operations, not
// by its 16 bytes per element of device-memory traffic. This first design keeps
// the arithmetic simple: each product goes unreduced into a three-word
// (192-bit) accumulator and is folded mod p once per output. The redesign that
// moves the contraction onto the int8 tensor cores (s8 x s8 -> s32 digit
// planes, as the TPU kernel does on its MXU) is recorded in ROADMAP.md.
//
// Layout: a block of 256 threads owns a tile of KT = min(n, 32) output
// columns k and walks kRowIters passes of 256 / KT rows. The W column tile
// (n x KT u64, at most 64 KB at n = 256) and the pass's data rows sit in
// shared memory; W is symmetric, so the tile W[i][k0 + kk] is read from
// contiguous rows. A warp reads KT consecutive W words (no bank conflict)
// and broadcasts its row's data word.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int kThreads = 256;
constexpr int kRowIters = 8;
constexpr int kMaxLogKt = 5;

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

__global__ void __launch_bounds__(kThreads)
base_dft_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ w,
                uint64_t* __restrict__ out, long long rows, int log_n, int log_kt) {
  extern __shared__ uint64_t smem[];
  const int n = 1 << log_n;
  const int kt = 1 << log_kt;
  const int rows_per_pass = kThreads >> log_kt;
  uint64_t* w_s = smem;           // [i][kk], n * kt words
  uint64_t* a_s = smem + n * kt;  // [rr][i], rows_per_pass * n words
  const int k0 = blockIdx.y * kt;
  const int tid = threadIdx.x;

  for (int e = tid; e < n * kt; e += kThreads) {
    w_s[e] = w[(size_t)(e >> log_kt) * n + k0 + (e & (kt - 1))];
  }
  const int kk = tid & (kt - 1);
  const int rr = tid >> log_kt;
  const long long row_base = (long long)blockIdx.x * rows_per_pass * kRowIters;

  for (int it = 0; it < kRowIters; ++it) {
    const long long r0 = row_base + (long long)it * rows_per_pass;
    if (r0 >= rows) break;  // uniform across the block
    __syncthreads();        // the previous pass has finished reading a_s
    for (int e = tid; e < rows_per_pass * n; e += kThreads) {
      const long long r = r0 + (e >> log_n);
      a_s[e] = r < rows ? a[r * n + (e & (n - 1))] : 0;
    }
    __syncthreads();
    const long long r = r0 + rr;
    if (r < rows) {
      const uint64_t* ar = a_s + rr * n;
      uint64_t acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < n; ++i) {
        const uint64_t x = ar[i];
        const uint64_t y = w_s[i * kt + kk];
        const uint64_t lo = x * y;
        acc0 += lo;
        // the high word of a 64x64 product is at most 2^64 - 2: adding the
        // carry cannot overflow
        const uint64_t hi = __umul64hi(x, y) + (acc0 < lo ? 1ull : 0ull);
        acc1 += hi;
        acc2 += acc1 < hi ? 1ull : 0ull;
      }
      // acc0 + acc1 * 2^64 + acc2 * 2^128, and 2^128 = -2^32 (mod p); acc2 <= n
      out[r * n + k0 + kk] = sub_mod(reduce128(acc0, acc1), acc2 << 32);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ethproof_base_dft(const void* a, const void* w, void* out, long long rows,
                                 int log_n, void* stream) {
  if (log_n < 1 || log_n > 8 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int log_kt = log_n < kMaxLogKt ? log_n : kMaxLogKt;
  const int n = 1 << log_n;
  const int kt = 1 << log_kt;
  const int rows_per_pass = kThreads / kt;
  const size_t smem = (size_t)(n * kt + rows_per_pass * n) * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      base_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)rows_per_pass * kRowIters;
  const dim3 grid((unsigned)((rows + rows_per_block - 1) / rows_per_block), (unsigned)(n / kt));
  base_dft_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)a, (const uint64_t*)w, (uint64_t*)out, rows, log_n, log_kt);
  return (int)cudaGetLastError();
}
