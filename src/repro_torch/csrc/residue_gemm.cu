// The low-precision residue GEMMs of the phase-split Ozaki-II pipeline, for
// Hopper (sm_90a). One source, two entry points:
//
//   fp8_gemm  (K3) replaces repro/kernels/fp8_gemm/kernel.py::fp8_gemm
//             (body _gemm_kernel): e4m3 A (m, k) @ e4m3 B (k, n) -> f32 C;
//   int8_gemm (K4) replaces repro/kernels/int8_gemm/kernel.py::int8_gemm
//             (body _gemm_kernel): int8 A @ int8 B -> int32 C.
//
// The operands are one modulus' residue parts (|x| <= 16 in e4m3, |x| <= 128
// in int8), both row-major as the reference stores them, and C is one plane
// of the (N, m, n) product stack the requant/Garner pass (K5) reads.
//
// Schedule: one block of 8 warps per 128 x 128 output tile, each warp a
// 64 x 32 sub-tile (4 x 4 mma tiles of m16n8k32); the k loop copies a
// 64-deep k-tile of A (row-major, as stored) and of B (each thread reads
// 4 k rows of 4 columns and transposes them in registers, so that B sits
// k-contiguous per column for the .col operand) to shared memory, then runs
// the products into int32 accumulators in registers. Ragged edges are
// masked in the loads (zeros) and the stores, so no operand is padded and
// C is written in place into its plane of the stack. The vector loads (16
// bytes of A, 4 of B) need k % 16 == 0, n % 4 == 0 and aligned pointers;
// other shapes take a byte-wise load path of the same schedule.
//
// Exactness. FP8: each k32 step starts from a zero f32 fragment and is
// converted to int32 (mma_k32_exact: one step sums at most 32*16*16 = 2^13),
// so the sum is exact whatever the width of Hopper's FP8 accumulator; C is
// float(acc), exact for |acc| <= 2^24, i.e. k <= 2^16 (the wrapper's limit).
// int8: the s8 mma with s32 accumulation, exact for k <= 2^17.
//
// Bound. 2mnk FP8 (int8) tensor operations against the dense rate of 1,979
// TOP/s, and (mk + kn) bytes in, 4mn out. The operations bound it at the
// main path's shapes. This simple design (mma.sync, no TMA/wgmma, no
// multi-buffering, two blocks per SM overlap one another's loads) reads each
// A tile once per column block and each B tile once per row block, so L2
// traffic and load latency, not the tensor cores, hold it back; wgmma/TMA
// with a ring of tiles is the queued work (ROADMAP).

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

constexpr int TM = 128, TN = 128;      // output tile; BK = 64 (fused_common.cuh)
constexpr int TILE_BYTES = 128 * LDS;  // one operand's k-tile in shared memory

// The k-tile (rows row0..row0+127, k bytes k0..k0+63) of A into dst
// ([TM][LDS]): each thread 2 rows x 16 bytes. Out-of-range bytes are 0.
template <bool ALIGNED>
__device__ __forceinline__ void load_a_tile(uint8_t* dst, const uint8_t* a, int m, int k,
                                            int row0, int k0) {
  const int c = (threadIdx.x & 3) * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (threadIdx.x >> 2) + 64 * h;
    const int row = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if constexpr (ALIGNED) {
      if (row < m && k0 + c < k)
        v = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(row) * k + k0 + c);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (row < m) {
        const uint8_t* src = a + static_cast<size_t>(row) * k;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (k0 + c + j < k) w[j >> 2] |= static_cast<uint32_t>(src[k0 + c + j]) << (8 * (j & 3));
        }
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = v;
  }
}

// The k-tile (k rows k0..k0+63, columns col0..col0+127) of B into dst
// ([TN][LDS], k-contiguous per column): each thread 2 blocks of 4 k rows x
// 4 columns, transposed in registers. A warp reads 4 rows x 32 bytes per
// load. Out-of-range bytes are 0.
template <bool ALIGNED>
__device__ __forceinline__ void load_b_tile(uint8_t* dst, const uint8_t* b, int k, int n,
                                            int k0, int col0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kb = (lane >> 3) + 4 * (warp >> 1);  // k rows 4kb .. 4kb+3
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int cb = (lane & 7) + 8 * (warp & 1) + 16 * h;  // columns 4cb .. 4cb+3
    const int col = col0 + 4 * cb;
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + 4 * kb + i;
      if (row >= k) continue;
      const uint8_t* src = b + static_cast<size_t>(row) * n + col;
      if constexpr (ALIGNED) {
        if (col < n) w[i] = *reinterpret_cast<const uint32_t*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < n) w[i] |= static_cast<uint32_t>(src[j]) << (8 * j);
        }
      }
    }
    store_b_transposed(dst, w, 4 * cb, 4 * kb);
  }
}

template <bool INT8, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
residue_gemm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                    void* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) uint8_t a_s[TILE_BYTES];
  __shared__ __align__(16) uint8_t b_s[TILE_BYTES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;

  int acc[4][4][4] = {};
  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();  // the previous k-tile is consumed
    load_a_tile<ALIGNED>(a_s, a, m, k, row0, k0);
    load_b_tile<ALIGNED>(b_s, b, k, n, k0, col0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        load_a(af[i], a_s + (wm + 16 * i) * LDS + kk, lane);
        load_b(bf[i], b_s + (wn + 8 * i) * LDS + kk, lane);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (INT8) {
            mma_s8(acc[mi][ni], af[mi], bf[ni]);
          } else {
            mma_k32_exact(acc[mi][ni], af[mi], bf[ni]);
          }
        }
      }
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = row0 + wm + 16 * mi + g + 8 * (q >> 1);
        const int col = col0 + wn + 8 * ni + 2 * t + (q & 1);
        if (row >= m || col >= n) continue;
        const size_t i = static_cast<size_t>(row) * n + col;
        if constexpr (INT8) {
          static_cast<int*>(out)[i] = acc[mi][ni][q];
        } else {
          static_cast<float*>(out)[i] = static_cast<float>(acc[mi][ni][q]);
        }
      }
    }
  }
}

template <bool INT8>
int launch(const void* a, const void* b, void* out, int m, int n, int k, int aligned, int device,
           void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + TM - 1) / TM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  if (aligned && (k % 16 || n % 4 || reinterpret_cast<uintptr_t>(pa) % 16 ||
                  reinterpret_cast<uintptr_t>(pb) % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  return on_device(device, [&]() {
    auto s = static_cast<cudaStream_t>(stream);
    if (aligned) {
      residue_gemm_kernel<INT8, true><<<grid, THREADS, 0, s>>>(pa, pb, out, m, n, k);
    } else {
      residue_gemm_kernel<INT8, false><<<grid, THREADS, 0, s>>>(pa, pb, out, m, n, k);
    }
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Launch on `stream`: C (m x n, f32, row stride n) = A (m x k, e4m3 bytes,
// row-major) @ B (k x n, e4m3 bytes, row-major), all device pointers.
// `aligned` != 0 selects the vector loads and requires k % 16 == 0,
// n % 4 == 0, A 16-byte and B 4-byte aligned. Returns the CUDA error of the
// launch (0 on success).
int fp8_gemm_launch(const void* a, const void* b, float* out, int m, int n, int k, int aligned,
                    int device, void* stream) {
  return launch<false>(a, b, out, m, n, k, aligned, device, stream);
}

// The same for int8 A and B and an int32 C.
int int8_gemm_launch(const void* a, const void* b, int* out, int m, int n, int k, int aligned,
                     int device, void* stream) {
  return launch<true>(a, b, out, m, n, k, aligned, device, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
