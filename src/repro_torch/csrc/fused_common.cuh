// Device code shared by the two fused Ozaki-II kernels of repro_torch:
// fused_raw.cu (K1, residues built on chip from raw frames) and
// fused_parts.cu (K2, residue parts read from prepared stacks). The
// phase-split kernels use parts of it too: residue_gemm.cu (K3/K4) the MMA
// step, the fragment loads and the B transpose; requant_garner.cu (K5) and
// quant_residues.cu (K6) the moduli parameter block.
//
// Both run the same schedule: one block of 8 warps per 64 x 64 output tile,
// each warp a 32 x 16 sub-tile (2 x 2 mma tiles of m16n8); the moduli in the
// OUTER loop; per modulus, the k loop fills the part buffers of one 64-deep
// k-tile in shared memory (A row-major, B k-contiguous per column for the
// .col operand), runs the products into 3 (fp8) or 1 (int8) int32
// accumulators in registers, and at the end of k reduces them to one centred
// int16 residue tile in shared memory. After the last modulus every thread
// runs Garner, the Kahan sum and ldexp_wide on its elements and writes f64.
// The kernels differ only in how a k-tile's parts reach shared memory.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ozaki_int.cuh"

namespace fused {

constexpr int BM = 64, BN = 64, BK = 64;  // KERNEL_TILE in kernels/fused/kernel.py
constexpr int THREADS = 256;              // 8 warps: 2 along m x 4 along n
constexpr int LDS = BK + 16;              // part row stride (bytes): conflict-free fragment loads
constexpr int PART = 64 * LDS;            // one part buffer (BM == BN == 64 rows)
constexpr int MAXN = 20;                  // MAX_MODULI in kernels/fused/kernel.py
constexpr int KIND_SQUARE = 0, KIND_KARATSUBA = 1, KIND_INT8 = 2;

// e4m3 parts per modulus and operand (a square modulus has no hs part), and
// int32 accumulators per modulus.
template <int KIND>
constexpr int kParts = KIND == KIND_KARATSUBA ? 3 : (KIND == KIND_SQUARE ? 2 : 1);
template <int KIND>
constexpr int kAccs = KIND == KIND_INT8 ? 1 : 3;

// Moduli constants, passed by value (__grid_constant__) and copied to shared
// memory for dynamic indexing.
struct Moduli {
  int n;
  int ps[MAXN];           // selection order
  int split_s[MAXN];
  int kind[MAXN];
  int radix_order[MAXN];  // Garner digit i reads the residue of ps[radix_order[i]]
  int radix_ps[MAXN];
  int inv[MAXN * MAXN];   // inv[j * MAXN + i] = radix_ps[j]^-1 mod radix_ps[i]
  double w[MAXN];         // radix weights, float64
};

// The parameter block from the host arrays of the C entry points (num_moduli
// entries each; inv num_moduli x num_moduli, row-major).
inline Moduli make_moduli(int num_moduli, const int* ps, const int* split_s, const int* kind,
                          const int* radix_order, const int* radix_ps, const int* inv,
                          const double* weights) {
  Moduli mod{};
  mod.n = num_moduli;
  for (int i = 0; i < num_moduli; ++i) {
    mod.ps[i] = ps[i];
    mod.split_s[i] = split_s[i];
    mod.kind[i] = kind[i];
    mod.radix_order[i] = radix_order[i];
    mod.radix_ps[i] = radix_ps[i];
    mod.w[i] = weights[i];
    for (int j = 0; j < num_moduli; ++j) mod.inv[j * MAXN + i] = inv[j * num_moduli + i];
  }
  return mod;
}

__device__ __forceinline__ void copy_moduli(Moduli& dst, const Moduli& src) {
  const int* s = reinterpret_cast<const int*>(&src);
  int* d = reinterpret_cast<int*>(&dst);
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(Moduli) / sizeof(int)); i += THREADS)
    d[i] = s[i];
}

__device__ __forceinline__ void mma_e4m3(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// The kernels' k32 FP8 step (_dot_i32): product from a zero fragment,
// converted to int32 and added to the accumulators.
__device__ __forceinline__ void mma_k32_exact(int (&acc)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float d[4];
  mma_e4m3(d, a, b, zero);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += __float2int_rn(d[q]);
}

__device__ __forceinline__ void mma_s8(int (&acc)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// m16n8k32 fragments (8-bit A row-major, B column-major): lane = 4*g + t holds
// A rows g and g+8, k bytes 4t..4t+3 and 16+4t..; B column g, the same k bytes.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* base, int lane) {
  const uint8_t* p0 = base + (lane >> 2) * LDS + (lane & 3) * 4;
  const uint8_t* p1 = p0 + 8 * LDS;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
}

__device__ __forceinline__ void load_b(uint32_t (&b)[2], const uint8_t* base, int lane) {
  const uint8_t* p = base + (lane >> 2) * LDS + (lane & 3) * 4;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

// Four k rows of four B columns (w[i]: row i's 4 column bytes) stored
// k-contiguous per column for the .col operand of mma.sync: column col + j
// of dst ([cols][LDS]) gets the k bytes kbyte..kbyte+3. This 4 x 4 byte
// transpose in registers lets B arrive in its row-major (k, n) layout.
__device__ __forceinline__ void store_b_transposed(uint8_t* dst, const uint32_t (&w)[4],
                                                   int col, int kbyte) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) v |= ((w[i] >> (8 * j)) & 0xFFu) << (8 * i);
    *reinterpret_cast<uint32_t*>(dst + (col + j) * LDS + kbyte) = v;
  }
}

// The products of one k-tile whose parts sit in a_s ([3][BM][LDS]) and b_s
// ([3][BN][LDS], k-contiguous per column): eq. (12) for a square modulus
// (A1B2, A2B1, A2B2), eq. (8) for a Karatsuba modulus (A1B1, A2B2,
// (A1+A2)(B1+B2)), the single product for int8.
template <int KIND>
__device__ __forceinline__ void mma_tile(int (&acc)[kAccs<KIND>][2][2][4], const uint8_t* a_s,
                                         const uint8_t* b_s) {
  constexpr int NP = kParts<KIND>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t af[NP][2][4], bf[NP][2][2];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        load_a(af[q][i], a_s + q * PART + (wm + 16 * i) * LDS + kk, lane);
        load_b(bf[q][i], b_s + q * PART + (wn + 8 * i) * LDS + kk, lane);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        if constexpr (KIND == KIND_INT8) {
          mma_s8(acc[0][mi][ni], af[0][mi], bf[0][ni]);
        } else if constexpr (KIND == KIND_SQUARE) {
          mma_k32_exact(acc[0][mi][ni], af[0][mi], bf[1][ni]);
          mma_k32_exact(acc[1][mi][ni], af[1][mi], bf[0][ni]);
          mma_k32_exact(acc[2][mi][ni], af[1][mi], bf[1][ni]);
        } else {
#pragma unroll
          for (int q = 0; q < 3; ++q) mma_k32_exact(acc[q][mi][ni], af[q][mi], bf[q][ni]);
        }
      }
    }
  }
}

// End of one modulus' k loop: the centred residue of the tile's product
// into res (BM x BN int16).
template <int KIND>
__device__ __forceinline__ void store_residue(const int (&acc)[kAccs<KIND>][2][2][4], int p,
                                              int s, int16_t* res) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = wm + 16 * mi + g + 8 * (q >> 1);
        const int col = wn + 8 * ni + 2 * t + (q & 1);
        int c;
        if constexpr (KIND == KIND_INT8) {
          c = ozaki::cmod(acc[0][mi][ni][q], p);
        } else {
          c = ozaki::combine(acc[0][mi][ni][q], acc[1][mi][ni][q], acc[2][mi][ni][q], p,
                             KIND == KIND_SQUARE, s);
        }
        res[row * BN + col] = static_cast<int16_t>(c);
      }
    }
  }
}

// Garner digits, Kahan f64 sum in radix order, ldexp_wide (_finalize), from
// the N residue tiles res_s ([N][BM][BN]) to the f64 tile of C at
// (row0, col0); n is the row stride of C.
__device__ __forceinline__ void finalize(const Moduli& M, const int16_t* res_s, const int* lmu,
                                         const int* lnu, double* out, int row0, int col0,
                                         int n) {
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    int digits[MAXN];
    for (int d = 0; d < M.n; ++d) {
      digits[d] = ozaki::garner_digit(res_s[M.radix_order[d] * BM * BN + i], M.radix_ps[d],
                                      digits, &M.inv[d], MAXN, d);
    }
    double sum = __dmul_rn(static_cast<double>(digits[0]), 0.0), comp = sum;
    for (int d = 0; d < M.n; ++d) {
      const double term = __fma_rn(static_cast<double>(digits[d]), M.w[d], -comp);
      const double next = __dadd_rn(sum, term);
      comp = __dsub_rn(__dsub_rn(next, sum), term);
      sum = next;
    }
    out[static_cast<size_t>(row0 + r) * n + col0 + c] =
        ozaki::ldexp_wide(sum, -(lmu[row0 + r] + lnu[col0 + c]));
  }
}

// Runs fn with `device` current and restores the caller's device after.
template <typename Fn>
int on_device(int device, Fn fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fn();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace fused
