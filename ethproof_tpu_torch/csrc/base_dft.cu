// Exact Goldilocks DFT along the last axis on the int8 tensor cores:
// out[r, k] = sum_i a[r, i] * W[k, i] mod p, p = 2^64 - 2^32 + 1, for a
// contiguous (rows, n) u64 array and n = 2^log_n <= 256. W[k, i] = w^(k*i)
// for the order-n root w (or its inverse); the inverse's 1/n scale is the
// caller's.
//
// Replaces ethproof_tpu/poly/pallas_ntt.py::_dft_kernel_i8 with the same
// digit formulation (ethproof_tpu/poly/mxu_ntt.py, `_dft_matrix_i8`):
//   - data: eight OFFSET digits d_c = byte c of a - 128 (byte ^ 0x80 read as
//     s8), which encode a - K with K = 128 (2^64 - 1) / 255 and need no
//     carries;
//   - weights: eight BALANCED digits m_c in [-128, 127] of a representative
//     of W (host-built, zero past n so that padding contributes nothing);
//   - every (data plane dc, weight plane wc) pair is one
//     mma.sync.m16n8k32.row.col.s32.s8.s8.s32 chain whose C operand is bucket
//     dc + wc itself: |product| <= 2^14 and |bucket| <= 8 * n * 2^14 <= 2^25,
//     so int32 accumulates every bucket exactly and nothing is converted;
//   - goldilocks.cuh::fold_buckets turns the 15 buckets into a field element
//     and the host's row adds K * sum_i W'[k, i], the JAX package's bias
//     total and the fold's bias, mod p (poly/base_dft.py, `kernel_row_i8`).
// The TPU kernel's 128-lane block-diagonal replication and 2^15-element row
// blocks are not carried over.
//
// What bounds it on an H100: 2 * 64 * n s8 operations per output element at
// 1979 TOPS against 16 B per element of device-memory traffic at 3.35 TB/s:
// operations for n >= 4 (n = 128: 8.3 ps against 4.8 ps per element). Next
// to the tensor cores stands the epilogue, about 70 integer instructions per
// element whatever n is, which may set the pace at n <= 32.
//
// Layout and what it answers (the first design, a 64x64-bit scalar
// multiply-add per term, re-read every row once for each 32-column tile):
//   - a block of 8 warps owns RT rows and ALL n output columns, with
//     RT * max(n, 32) * 8 B = 64 KiB of digit planes (RT = 256, 128, 64, 32
//     rows at n <= 32, 64, 128, 256; down to 16 rows while the grid would
//     have under two blocks per SM). It reads its rows from device memory
//     once, 16 B a lane, and writes the eight offset-digit planes once into
//     shared memory in fragment order (goldilocks.cuh, FragmentOrder): a
//     4x4 byte transpose of four consecutive elements gives one A register
//     of each plane;
//   - the warps then walk the (16-row, 8-column) output tiles, column-tile
//     major so that warps that run together share weights. For each
//     32-term step a warp reads 8 A fragments (one 16-byte shared load each)
//     and 8 B fragments (four 16-byte loads of the host's fragment-ordered
//     digit table, 8 n^2 B, which every block reads and which stays in L2;
//     the next step's are loaded before this step's 64 MMAs), and issues
//     the 64 MMAs into its 15 accumulator fragments;
//   - n < 32 takes the same path with the contraction zero-padded to 32 and,
//     for n < 8, a partly empty column tile.
// ptxas (sm_90a, CUDA 12.8, `-Xptxas -v` as `chip_smoke.py` prints it): 126
// registers, no spills, no static shared memory; 64 KiB of dynamic shared
// memory per block, so two blocks (16 warps) to an SM, bound by registers.
// On the card (PERF.md, Findings) the MMA loop runs at about 45% of the int8
// peak and the row tile's read, the loop and the epilogue add up rather
// than overlap, as copies of this kernel without the MMAs, without the
// epilogue or with the row tile's read alone show.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

using namespace goldilocks;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLogPlaneBytes = 16;  // 64 KiB of digit planes per block
constexpr long long kMinBlocks = 264;  // two blocks on each of an H100's 132 SMs

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
base_dft_kernel(const uint64_t* __restrict__ a, const uint4* __restrict__ wfrag,
                const uint64_t* __restrict__ row_add, uint64_t* __restrict__ out,
                long long rows, int log_n, int log_rt) {
  extern __shared__ uint4 a_s[];  // [16-row tile][step][plane][lane]
  const int n = 1 << log_n;
  const int steps = n < 32 ? 1 : n >> 5;     // 32-term contraction steps
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

  // 1. The block's rows, read once, as eight offset-digit planes in fragment
  //    order. A unit is one (16-row tile, step): the lane reads the four
  //    4-term runs of its A registers (rows g and g + 8, terms 4t and
  //    16 + 4t of the step).
  for (int unit = warp; unit < steps * mt_live; unit += kWarps) {
    const int mt = unit / steps;
    const int step = unit - mt * steps;
    uint32_t planes[8][4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const long long r = row0 + mt * 16 + g + 8 * (reg & 1);
      const int i0 = step * 32 + 4 * t + 16 * (reg >> 1);
      uint32_t lo[4] = {0u, 0u, 0u, 0u};
      uint32_t hi[4] = {0u, 0u, 0u, 0u};
      if (n >= 4) {  // i0 is a multiple of 4, so i0 < n means i0 + 3 < n
        if (r < rows && i0 < n) {
          const uint4* p = reinterpret_cast<const uint4*>(a + r * n + i0);
          const uint4 v0 = __ldg(p);
          const uint4 v1 = __ldg(p + 1);
          lo[0] = v0.x; hi[0] = v0.y; lo[1] = v0.z; hi[1] = v0.w;
          lo[2] = v1.x; hi[2] = v1.y; lo[3] = v1.z; hi[3] = v1.w;
        }
      } else {  // n = 2
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (r < rows && i0 + j < n) {
            const uint64_t x = __ldg(a + r * n + i0 + j);
            lo[j] = (uint32_t)x;
            hi[j] = (uint32_t)(x >> 32);
          }
        }
      }
      uint32_t plo[4], phi[4];
      byte_transpose(lo[0], lo[1], lo[2], lo[3], plo);
      byte_transpose(hi[0], hi[1], hi[2], hi[3], phi);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        planes[c][reg] = plo[c] ^ 0x80808080u;  // byte - 128 as s8
        planes[c + 4][reg] = phi[c] ^ 0x80808080u;
      }
    }
#pragma unroll
    for (int dc = 0; dc < 8; ++dc) {
      a_s[(unit * 8 + dc) * 32 + lane] =
          make_uint4(planes[dc][0], planes[dc][1], planes[dc][2], planes[dc][3]);
    }
  }
  __syncthreads();

  // 2. Output tiles: 64 MMAs per step into 15 bucket fragments, then the fold.
  for (int job = warp; job < col_tiles * mt_live; job += kWarps) {
    const int mt = job % mt_live;
    const int nt = job / mt_live;
    int acc[kBuckets][4];
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] = 0;
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
#pragma unroll
      for (int dc = 0; dc < 8; ++dc) {
        const uint4 av = ap[(step * 8 + dc) * 32];
#pragma unroll
        for (int wc = 0; wc < 8; ++wc) {
          const uint4& bq = bw[wc >> 1];
          mma_s8(acc[dc + wc], av, (wc & 1) ? bq.z : bq.x, (wc & 1) ? bq.w : bq.y);
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
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = row0 + mt * 16 + g + 8 * half;
        int v0[kBuckets], v1[kBuckets];
#pragma unroll
        for (int b = 0; b < kBuckets; ++b) {
          v0[b] = acc[b][2 * half];
          v1[b] = acc[b][2 * half + 1];
        }
        const uint64_t o0 = add_mod(fold_buckets(v0), add0);
        const uint64_t o1 = add_mod(fold_buckets(v1), add1);
        if (r < rows) *reinterpret_cast<ulonglong2*>(out + r * n + k) = make_ulonglong2(o0, o1);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns a cudaError_t (0 on success). `wfrag` is
// the host's fragment-ordered weight-digit table and `row_add` the (n,) u64
// row added to each output column (poly/base_dft.py); `a`, `wfrag` and `out`
// must be 16-byte aligned.
extern "C" int ethproof_base_dft(const void* a, const void* wfrag, const void* row_add, void* out,
                                 long long rows, int log_n, void* stream) {
  if (log_n < 1 || log_n > 8 || rows <= 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a | (uintptr_t)wfrag | (uintptr_t)out) & 15) return (int)cudaErrorInvalidValue;
  const int log_kpad = log_n < 5 ? 5 : log_n;
  int log_rt = kLogPlaneBytes - 3 - log_kpad;  // RT * kpad * 8 B = 64 KiB
  // a small call takes smaller row tiles (down to 16 rows) to reach more SMs
  while (log_rt > 4 && ((rows + (1LL << log_rt) - 1) >> log_rt) < kMinBlocks) --log_rt;
  const int smem = 1 << (log_rt + log_kpad + 3);
  cudaError_t err = cudaFuncSetAttribute(
      base_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 1 << kLogPlaneBytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + (1LL << log_rt) - 1) >> log_rt;
  base_dft_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)a, (const uint4*)wfrag, (const uint64_t*)row_add, (uint64_t*)out, rows,
      log_n, log_rt);
  return (int)cudaGetLastError();
}
