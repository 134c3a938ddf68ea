// Exact Goldilocks DFT along the last axis in the bf16 encoding, on the
// tensor cores: out[r, k] = sum_i a[r, i] * W[k, i] mod p, p = 2^64 - 2^32 + 1,
// for a contiguous (rows, n) u64 array and n = 2^log_n <= 256. W[k, i] =
// w^(k*i) for the order-n root w (or its inverse); the inverse's 1/n scale is
// the caller's.
//
// Replaces ethproof_tpu/poly/pallas_ntt.py::_dft_kernel (the TPU MXU kernel of
// the bf16 encoding) with the same chunked formulation and the same canonical
// bits:
//   - every u64 is split into eight unsigned 8-bit chunks, exact in bf16; the
//     DFT matrix likewise (eight chunk planes, host-built, zero past n);
//   - each (data chunk dc, weight chunk wc) product is one
//     mma.sync.m16n8k16 bf16 x bf16 -> f32 per 16-term step; a product is
//     below 2^16.
// Exactness: f32 holds every integer below 2^24. The pairs of a bucket b =
// dc + wc (at most 8) form ONE f32 chain per 16-term step, whose C operand
// starts at 2^23: the step adds at most 8 * 16 * 255^2 = 8,323,200 < 2^23, so
// every partial sum is an integer in [2^23, 2^24), exact, and the f32 bits
// of the chain minus 0x4B000000 (the bits of 2^23) ARE the integer sum. So a
// conversion is one integer add of the f32 bits (no F2I), taken once per
// bucket and step: 15 * max(n, 16) / 16 conversions per output element (15,
// 30, 60, 120, 240 at n <= 16, 32, 64, 128, 256), against 64 F2I of the first
// design. Buckets 12..14 go straight into buckets 0..2 with 2^96 = -1, so
// the kernel keeps 12 int32 sums per output; a bucket reaches 8 * 255^2 * 256
// < 2^27 and the folded differences stay below 2^27 in magnitude, as
// goldilocks.cuh::fold12 needs with its bias of 2^27. The host's row takes the
// bias off mod p (poly/base_dft.py, `kernel_row_bf16`).
//
// What bounds it on an H100: 2 * 64 * n bf16 operations per output element
// at 989 TFLOP/s against 16 B per element of device-memory traffic at 3.35
// TB/s: operations for n >= 4 (n = 64: 8.3 ps against 4.8 ps per element).
//
// Layout and what it answers (the first design re-read every row from L2 for
// each of its n/8 column tiles, rebuilt each A fragment from u64 words for
// every chunk plane and step, converted all 64 dots with F2I, and ran 4
// warps without pipelining):
//   - a block of 4 warps owns RT rows and ALL n output columns, with RT *
//     max(n, 16) * 16 B = 64 KiB of chunk planes (RT = 256, 128, 64, 32, 16
//     rows at n <= 16, 32, 64, 128, 256; down to 16 rows while the grid would
//     have under two blocks per SM), three blocks to an SM. It reads its
//     rows from device memory once, 16 B a lane, and builds the eight bf16
//     chunk planes ONCE per row tile into shared memory in fragment order
//     (goldilocks.cuh, FragmentOrder; chunk -> bf16 by the exact 2^23 float
//     trick and a byte permute, no I2F);
//   - the warps then walk the (16-row, 8-column) output tiles: per 16-term
//     step, 8 A fragments (one 16-byte shared load each), 8 B fragments (four
//     16-byte loads of the host's fragment-ordered chunk table, 16 n^2 B,
//     which stays in L2; the next step's are loaded before this step's MMAs),
//     64 MMAs into 15 f32 chains, 60 integer adds;
//   - n < 16 takes the same path with the contraction zero-padded to 16 and,
//     for n < 8, a partly empty column tile.
// ptxas (sm_90a, CUDA 12.8, `-Xptxas -v` as `chip_smoke.py` prints it): 166
// registers, no spills, no static shared memory; 64 KiB of dynamic shared
// memory per block, three blocks (12 warps) to an SM. On the card (PERF.md,
// Findings) the MMA loop runs at about 47% of the bf16 peak, and the row tile's
// read, the loop and the epilogue add up, as copies of this kernel without
// the MMAs, without the epilogue or with the row tile's read alone show.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

using namespace goldilocks;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLogPlaneBytes = 16;    // 64 KiB of chunk planes per block
constexpr long long kMinBlocks = 264;  // two blocks on each of an H100's 132 SMs
constexpr uint32_t kTwo23 = 0x4B000000u;  // the f32 bits of 2^23

// D = A * B + C with C the chain's start, 2^23 in every element.
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint4& a, uint32_t b0,
                                               uint32_t b1, float c) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "f"(c));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The bf16 pair {chunk c of x0 (low half), chunk c of x1 (high half)} of two
// words: 0x4B0000cc is the f32 2^23 + cc, so subtracting 2^23 gives cc
// exactly; below 256 its top 16 bits are its bf16 bits.
__device__ __forceinline__ uint32_t chunk_pair(uint32_t x0, uint32_t x1, int c) {
  const float f0 = __uint_as_float(__byte_perm(x0, kTwo23, 0x7540 | c)) - 8388608.0f;
  const float f1 = __uint_as_float(__byte_perm(x1, kTwo23, 0x7540 | c)) - 8388608.0f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

__global__ void __launch_bounds__(kThreads, 3)
base_dft_bf16_kernel(const uint64_t* __restrict__ a, const uint4* __restrict__ wfrag,
                     const uint64_t* __restrict__ row_add, uint64_t* __restrict__ out,
                     long long rows, int log_n, int log_rt) {
  extern __shared__ uint4 a_s[];  // [16-row tile][step][plane][lane]
  const int n = 1 << log_n;
  const int steps = n < 16 ? 1 : n >> 4;     // 16-term contraction steps
  const int log_mt = log_rt - 4;             // 16-row tiles per block
  const int col_tiles = n < 8 ? 1 : n >> 3;  // 8-column output tiles
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long row0 = (long long)blockIdx.x << log_rt;
  // 16-row tiles that hold rows: all but in the last block of a ragged call
  const long long left = rows - row0;
  const int mt_live = left >= (1LL << log_rt) ? 1 << log_mt : (int)((left + 15) >> 4);

  // 1. The block's rows, read once, as eight bf16 chunk planes in fragment
  //    order. A unit is one (16-row tile, step): the lane reads the two-term
  //    runs of its A registers (rows g and g + 8, terms 2t and 2t + 8).
  for (int unit = warp; unit < steps * mt_live; unit += kWarps) {
    const int mt = unit / steps;
    const int step = unit - mt * steps;
    uint32_t planes[8][4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const long long r = row0 + mt * 16 + g + 8 * (reg & 1);
      const int i0 = step * 16 + 2 * t + 8 * (reg >> 1);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);  // {lo, hi} of terms i0, i0 + 1
      if (n >= 16) {
        if (r < rows) v = __ldg(reinterpret_cast<const uint4*>(a + r * n + i0));
      } else if (r < rows && i0 < n) {  // n is even: i0 + 1 < n too
        v = __ldg(reinterpret_cast<const uint4*>(a + r * n + i0));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        planes[c][reg] = chunk_pair(v.x, v.z, c);
        planes[c + 4][reg] = chunk_pair(v.y, v.w, c);
      }
    }
#pragma unroll
    for (int dc = 0; dc < 8; ++dc) {
      a_s[(unit * 8 + dc) * 32 + lane] =
          make_uint4(planes[dc][0], planes[dc][1], planes[dc][2], planes[dc][3]);
    }
  }
  __syncthreads();

  // 2. Output tiles: per step 64 MMAs into 15 f32 chains, each chain's bits
  //    added into its folded int32 sum; then the fold.
  const float two23 = __uint_as_float(kTwo23);
  for (int job = warp; job < col_tiles * mt_live; job += kWarps) {
    const int mt = job % mt_live;
    const int nt = job / mt_live;
    uint32_t u[12][4];
#pragma unroll
    for (int b = 0; b < 12; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) u[b][e] = 0u;
    }
    const uint4* bp = wfrag + (size_t)nt * steps * 4 * 32 + lane;  // [tile][step][pair][lane]
    const uint4* ap = a_s + (size_t)mt * steps * 8 * 32 + lane;
    uint4 bw[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bw[q] = __ldg(bp + q * 32);
#pragma unroll 1
    for (int step = 0; step < steps; ++step) {
      uint4 bnext[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bnext[q] = step + 1 < steps ? __ldg(bp + ((step + 1) * 4 + q) * 32) : bw[q];
      }
      float acc[kBuckets][4];
#pragma unroll
      for (int dc = 0; dc < 8; ++dc) {
        const uint4 av = ap[(step * 8 + dc) * 32];
#pragma unroll
        for (int wc = 0; wc < 8; ++wc) {
          const uint4& bq = bw[wc >> 1];
          const uint32_t b0 = (wc & 1) ? bq.z : bq.x;
          const uint32_t b1 = (wc & 1) ? bq.w : bq.y;
          // in this loop order (dc, wc) opens its bucket's chain iff dc == 0
          // or wc == 7
          if (dc == 0 || wc == 7) {
            mma_bf16_first(acc[dc + wc], av, b0, b1, two23);
          } else {
            mma_bf16(acc[dc + wc], av, b0, b1);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kBuckets; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bits = __float_as_uint(acc[b][e]);  // 2^23 + chain sum
          // 2^96 = -1: bucket b >= 12 goes into b - 12, and the two 2^23s cancel
          if (b < 12) {
            u[b][e] += bits;
          } else {
            u[b % 12][e] -= bits;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) bw[q] = bnext[q];
    }

    // C fragment: c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row g + 8
    const int k = nt * 8 + 2 * t;
    if (k < n) {  // n is even, so k + 1 < n too
      const uint64_t add0 = __ldg(row_add + k);
      const uint64_t add1 = __ldg(row_add + k + 1);
      // buckets 3..11 hold `steps` uncancelled 2^23s (mod 2^32)
      const uint32_t offset = (uint32_t)steps * kTwo23;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = row0 + mt * 16 + g + 8 * half;
        uint32_t v0[12], v1[12];
#pragma unroll
        for (int b = 0; b < 12; ++b) {
          const uint32_t bias = (uint32_t)kFoldBias - (b < 3 ? 0u : offset);
          v0[b] = u[b][2 * half] + bias;
          v1[b] = u[b][2 * half + 1] + bias;
        }
        const uint64_t o0 = add_mod(fold12(v0), add0);
        const uint64_t o1 = add_mod(fold12(v1), add1);
        if (r < rows) *reinterpret_cast<ulonglong2*>(out + r * n + k) = make_ulonglong2(o0, o1);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns a cudaError_t (0 on success). `wfrag` is
// the host's fragment-ordered bf16 chunk table of the DFT matrix and
// `row_add` the (n,) u64 row added to each output column (poly/base_dft.py);
// `a`, `wfrag` and `out` must be 16-byte aligned.
extern "C" int ethproof_base_dft_bf16(const void* a, const void* wfrag, const void* row_add,
                                      void* out, long long rows, int log_n, void* stream) {
  if (log_n < 1 || log_n > 8 || rows <= 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a | (uintptr_t)wfrag | (uintptr_t)out) & 15) return (int)cudaErrorInvalidValue;
  const int log_kpad = log_n < 4 ? 4 : log_n;
  int log_rt = kLogPlaneBytes - 4 - log_kpad;  // RT * kpad * 16 B = 64 KiB
  // a small call takes smaller row tiles (down to 16 rows) to reach more SMs
  while (log_rt > 4 && ((rows + (1LL << log_rt) - 1) >> log_rt) < kMinBlocks) --log_rt;
  const int smem = 1 << (log_rt + log_kpad + 4);
  cudaError_t err = cudaFuncSetAttribute(
      base_dft_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 1 << kLogPlaneBytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + (1LL << log_rt) - 1) >> log_rt;
  base_dft_bf16_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)a, (const uint4*)wfrag, (const uint64_t*)row_add, (uint64_t*)out, rows,
      log_n, log_rt);
  return (int)cudaGetLastError();
}
