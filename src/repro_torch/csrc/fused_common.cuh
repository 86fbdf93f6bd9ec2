// Device code shared by the CUDA kernels of repro_torch: the moduli
// parameter block (every kernel), the mma.sync FP8/int8 step and its
// fragment loads (the mma_sync route of K3/K4, residue_gemm.cu, and the
// mma.sync probe of fused_raw.cu), and the f64 epilogue of the fused kernels
// (garner, finalize: Garner digits, Kahan sum, ldexp_wide), which the Hopper
// GEMM core of K1/K2 (hopper_gemm.cuh) runs on each element of its tile and
// K5 (requant_garner.cu) on each element of C.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ozaki_int.cuh"

namespace fused {

constexpr int BK = 64;        // k-tile of the mma.sync kernel (K3/K4's mma_sync route)
constexpr int THREADS = 256;  // block size of the kernels other than the GEMM core
constexpr int LDS = BK + 16;  // part row stride (bytes): conflict-free fragment loads
constexpr int MAXN = 20;      // MAX_MODULI in kernels/launch.py
constexpr int KIND_SQUARE = 0, KIND_KARATSUBA = 1, KIND_INT8 = 2;

// e4m3 parts per modulus and operand (a square modulus has no hs part), and
// accumulators (products) per modulus.
template <int KIND>
constexpr int kParts = KIND == KIND_KARATSUBA ? 3 : (KIND == KIND_SQUARE ? 2 : 1);
template <int KIND>
constexpr int kAccs = KIND == KIND_INT8 ? 1 : 3;

// Moduli constants, passed by value (__grid_constant__) and copied to shared
// memory for dynamic indexing; read at constant indices (garner, finalize)
// straight from the parameter, they are instruction operands.
struct Moduli {
  int n;
  int ps[MAXN];           // selection order
  int split_s[MAXN];
  int kind[MAXN];
  int radix_order[MAXN];  // Garner digit i reads the residue of ps[radix_order[i]]
  int radix_ps[MAXN];
  double w[MAXN];         // radix weights, float64
  // the Garner steps' constants as f32 (garner): radix_ps, RN(1/radix_ps),
  // floor((radix_ps - 1) / 2), and rinv[j * MAXN + i] = radix_ps[j]^-1 mod
  // radix_ps[i].
  float rp[MAXN], rip[MAXN], rhalf[MAXN];
  float rinv[MAXN * MAXN];
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
    mod.rp[i] = static_cast<float>(radix_ps[i]);
    mod.rip[i] = 1.0f / mod.rp[i];  // IEEE division: RN(1/p), as __frcp_rn
    mod.rhalf[i] = static_cast<float>((radix_ps[i] - 1) / 2);
    for (int j = 0; j < num_moduli; ++j)
      mod.rinv[j * MAXN + i] = static_cast<float>(inv[j * num_moduli + i]);
  }
  return mod;
}

__device__ __forceinline__ void copy_moduli(Moduli& dst, const Moduli& src) {
  const int* s = reinterpret_cast<const int*>(&src);
  int* d = reinterpret_cast<int*>(&dst);
  constexpr int words = sizeof(Moduli) / sizeof(int);
  for (int i = threadIdx.x; i < words; i += blockDim.x) d[i] = s[i];
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

// ozaki::cmod(x, p) for |x| < 2^22 and p < 2^11 (the Garner steps: |x| <=
// 1089^2), from ip = 1/p in f32 instead of an integer division: x * ip is
// within 2^-9 of x / p, so its floor is off by at most one, and one
// correction gives the exact floor residue; then the same centring.
__device__ __forceinline__ int cmod_small(int x, int p, float ip) {
  int r = x - __float2int_rd(__fmul_rn(static_cast<float>(x), ip)) * p;
  r += r < 0 ? p : (r >= p ? -p : 0);
  return ozaki::centered(r, p);
}

// Balanced Garner digits (radix order) of E elements, as exact f32
// integers, interleaved step by step so that their dependency chains
// overlap. t[u] holds element u's centred residues in radix order (t[u][d]
// belongs to modulus ps[radix_order[d]]). The loops run to NMAX (<= MAXN,
// at least N) with a guard on N, so every index is a constant and the
// digits stay in registers; entries past NMAX are never touched.
//
// Each step (crt.garner_digits) is x = cmod((x - digit_j) * inv_j, p_d) on
// exact f32 integers, with f32 FMAs alone (cmod_small's int/float
// conversions issue several times slower). Only the digit must be the
// centred residue, so the steps before the last keep x by ozaki::mod_near
// (|x| <= p_d/2 + 1) and the last one takes ozaki::cmod_exact: |x -
// digit_j| <= 545.5 + 544 and inv_j < p_d <= 1089 keep every product below
// 2^21. The reference's last cmod of each digit is the identity: t and the
// last step's result are already centred mod p_d.
template <int E, int NMAX = MAXN>
__device__ __forceinline__ void garner(const Moduli& M, const int (&t)[E][MAXN],
                                       float (&digits)[E][MAXN]) {
  static_assert(NMAX <= MAXN, "NMAX exceeds the parameter block");
  const int n = M.n;
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    if (d < n) {
      const float p = M.rp[d], ip = M.rip[d], half = M.rhalf[d];
      float x[E];
#pragma unroll
      for (int u = 0; u < E; ++u) x[u] = ozaki::small_to_float(t[u][d]);
#pragma unroll
      for (int j = 0; j < d; ++j) {  // crt.garner_digits' step, E at a time
        const float inv = M.rinv[j * MAXN + d];
#pragma unroll
        for (int u = 0; u < E; ++u) {
          const float y = __fmul_rn(__fsub_rn(x[u], digits[u][j]), inv);
          x[u] = j + 1 < d ? ozaki::mod_near(y, p, ip) : ozaki::cmod_exact(y, p, ip, half);
        }
      }
#pragma unroll
      for (int u = 0; u < E; ++u) digits[u][d] = x[u];
    }
  }
}

// Garner digits, Kahan f64 sum in radix order, ldexp_wide (_finalize) of
// E elements of C (garner's t and NMAX), e[u] = -(lmu_i + lnu_j); each
// element's own order of operations is the reference's.
template <int E, int NMAX = MAXN>
__device__ __forceinline__ void finalize(const Moduli& M, const int (&t)[E][MAXN],
                                         const int (&e)[E], double (&v)[E]) {
  const int n = M.n;
  float digits[E][MAXN];
  garner<E, NMAX>(M, t, digits);
  double sum[E], comp[E];
#pragma unroll
  for (int u = 0; u < E; ++u) {
    sum[u] = __dmul_rn(static_cast<double>(digits[u][0]), 0.0);
    comp[u] = sum[u];
  }
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    if (d < n) {
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const double term = __fma_rn(static_cast<double>(digits[u][d]), M.w[d], -comp[u]);
        const double next = __dadd_rn(sum[u], term);
        comp[u] = __dsub_rn(__dsub_rn(next, sum[u]), term);
        sum[u] = next;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < E; ++u) v[u] = ozaki::ldexp_wide(sum[u], e[u]);
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
