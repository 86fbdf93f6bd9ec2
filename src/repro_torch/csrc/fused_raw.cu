// The whole Ozaki-II emulated DGEMM from raw frames, for Hopper (sm_90a).
// Replaces repro/kernels/fused/kernel.py::ozmm_fused_raw (body _kernel_raw,
// with _residue_tile, _split_fp8, _mma_fp8/_dot_i32 and _finalize), and
// computes what it computes:
//
//   per operand element, x = (mh*2^26 + ml) * 2^e (ops.decompose_raw) scaled
//   by the pairing exponent (lmu per row of A, lnu per column of B) and
//   truncated -> centred residue mod p -> e4m3 parts (or int8) -> the
//   eq. (8)/(12) products (or the single int8 product) -> combine -> balanced
//   Garner digits -> Kahan f64 sum -> ldexp_wide -> C; or, as the reference's
//   reconstruct="xla", the int16 Garner digit stack (N, m, n) instead of C.
//   Any k up to the reference's limits: 2^21 for the fp8 families, 2^16 for
//   int8 (the core accumulates in chunks of 2^16, hopper_gemm.cuh).
//
// Two steps on the stream, both hand-written:
//
// 1. The residue prologue (raw_parts_kernel), once per operand: one thread
//    per 16 elements of a 64 x 64 tile computes every modulus' residue from
//    the raw frames, each ONCE (N(mk + kn) residues in all), and writes the
//    parts into K-major stacks: A's (N, m, k) as stored, B's (N, n, k), the
//    transpose done in registers (a thread owns 16 k of one column), since
//    wgmma takes 8-bit operands only K-major. A square modulus writes no hs
//    part. The TPU kernel recomputed each tile's residues inside its MMA
//    loop to keep them out of HBM; on this card that recompute cost
//    N*mnk*(1/64 + 1/64) residues and bounded the kernel, while the parts of
//    one operand at 8192^2 are 2.4 GB, about 1 ms of HBM traffic.
// 2. The GEMM core of hopper_gemm.cuh (shared with K2): TMA ring, wgmma,
//    per-modulus residues into a scratch, finalize.
//
// The 2^e-mod-p tables (N x 1024 int32) sit in dynamic shared memory.
// Exactness: the residue arithmetic is exact integer arithmetic (each `mod
// p` from a reciprocal of p and one correction),
// the splits round as core/quantize.py does, the products are exact by
// promotion (hopper_gemm.cuh), the Kahan term is ONE __fma_rn (the
// reference's XLA contracts it) and the library is built with --fmad=false.
//
// Bound. 3N * 2mnk FP8 operations (N * 2mnk int8) against the dense tensor
// rate: 20.0 ms at 8192^3, N = 12. Bytes: the frames (12 bytes an element)
// in and the f64 C out, plus what the steps move between them: the parts
// (up to 3N bytes an element written, then read), the residue scratch (2N
// bytes an element of C, written and read back), and L2 traffic
// 3N * mnk * (1/128 + 1/128) for the core's 128 x 128 cluster tiles. The
// prologue is integer-bound (1.6e9 residues at 8192^2, N = 12); the core is
// bound by each warpgroup's alternation of wgmma and promotion adds
// (hopper_gemm.cuh). This file also holds the MMA probes of chip_smoke.py
// phase 2: mma.sync (the K3/K4 step) and wgmma (the core's step).

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_gemm.cuh"

namespace {

using namespace fused;

constexpr int TABLE_LEN = 1024;  // moduli.POW2_TABLE_LEN
constexpr int MANT_SPLIT = 26;
constexpr int PT = 64;  // prologue tile: 64 rows x 64 k, 16 k per thread

// x mod p for 0 <= x < 2^27 (a limb) from ip = 1/p in f64: x * ip is within
// 2^-25 of x / p, so its floor is off by at most one, which one correction
// undoes; the exact `%` at a few instructions instead of a division.
__device__ __forceinline__ int mod_limb(int x, int p, double ip) {
  const int r = x - __double2int_rd(__dmul_rn(static_cast<double>(x), ip)) * p;
  return r < 0 ? r + p : (r >= p ? r - p : r);
}

// Centred residue mod p of trunc(2^sc * (mh*2^26 + ml)) (_residue_tile):
// negative sc truncates by shifts of the magnitudes, the high-limb shift
// clipped to 31 (a shift of 32 or more is UB); positive sc multiplies by
// 2^sc mod p from the table, indices clipped to it; the sign comes back last.
// ip = 1/p; the weighted sum is < 2 * 1089^2 < 2^22, so its reduction is
// fused_common.cuh's cmod_small.
__device__ __forceinline__ int residue(int mh, int ml, int sc, int p, double ip,
                                       const int* pw) {
  const int amh = abs(mh), aml = abs(ml);
  const int sg = mh != 0 ? (mh > 0 ? 1 : -1) : (ml > 0) - (ml < 0);
  const int t = max(-sc, 0);
  const int tl = min(t, MANT_SPLIT);
  const int th = min(max(t - MANT_SPLIT, 0), 31);
  const int sp = max(sc, 0);
  const int wh = pw[min(MANT_SPLIT - tl + sp, TABLE_LEN - 1)];
  const int wl = pw[min(sp, TABLE_LEN - 1)];
  const int x = mod_limb(amh >> th, p, ip) * wh + mod_limb(aml >> tl, p, ip) * wl;
  return cmod_small(sg * cmod_small(x, p, static_cast<float>(ip)), p, static_cast<float>(ip));
}

// Residue -> part bytes (_split_fp8): (hi, lo) by a round-half-even split for
// a square modulus p = s^2, (hi, lo, hi + lo) by a ceil split for a
// Karatsuba modulus, the residue itself for int8.
template <int KIND>
__device__ __forceinline__ void store_parts(uint32_t (&b)[3], int r, int s) {
  if constexpr (KIND == KIND_INT8) {
    b[0] = static_cast<uint8_t>(static_cast<int8_t>(r));
  } else if constexpr (KIND == KIND_SQUARE) {
    const int hi = ozaki::split_square_hi(r, s);
    b[0] = ozaki::e4m3(hi);
    b[1] = ozaki::e4m3(r - s * hi);
  } else {
    const int hi = ozaki::split_karatsuba_hi(r);
    const int lo = r - 16 * hi;
    b[0] = ozaki::e4m3(hi);
    b[1] = ozaki::e4m3(lo);
    b[2] = ozaki::e4m3(hi + lo);
  }
}

// One modulus' parts of a thread's 16 elements (scaled exponents vs), 16
// bytes into each of the kind's part planes at dst[q] + o.
template <int KIND>
__device__ __forceinline__ void modulus_parts(const int (&vh)[16], const int (&vl)[16],
                                              const int (&vs)[16], int p, int s, const int* pw,
                                              uint8_t* const (&dst)[3], size_t o) {
  constexpr int NP = kParts<KIND>;
  const double ip = __drcp_rn(static_cast<double>(p));
  uint32_t w[NP][4] = {};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint32_t b[3];
    store_parts<KIND>(b, residue(vh[j], vl[j], vs[j], p, ip, pw), s);
#pragma unroll
    for (int q = 0; q < NP; ++q) w[q][j >> 2] |= b[q] << (8 * (j & 3));
  }
#pragma unroll
  for (int q = 0; q < NP; ++q)
    *reinterpret_cast<uint4*>(dst[q] + o) = make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
}

// The parts of one operand, K-major: rows x kdim frames (TRANS = false, A:
// row r at r * kdim) or kdim x rows frames (TRANS = true, B: column r at
// k * rows + r), lexp the pairing exponent of each row r, out (N, rows,
// kdim) planes hi, lo, hs (int8: hi only).
template <bool TRANS>
__global__ void __launch_bounds__(THREADS)
raw_parts_kernel(const int* __restrict__ mh, const int* __restrict__ ml,
                 const int* __restrict__ e, const int* __restrict__ lexp,
                 const int* __restrict__ tbl, uint8_t* hi, uint8_t* lo, uint8_t* hs, int rows,
                 int kdim, const __grid_constant__ Moduli mod) {
  extern __shared__ int tbl_s[];  // [N][TABLE_LEN]
  __shared__ Moduli M;
  copy_moduli(M, mod);
  for (int i = threadIdx.x; i < mod.n * TABLE_LEN; i += THREADS) tbl_s[i] = tbl[i];
  __syncthreads();
  // A: 4 threads cover a row's 64 k; B: 64 threads cover 64 columns of one
  // k row, so each warp's frame loads are contiguous either way
  const int r = TRANS ? (threadIdx.x & 63) : (threadIdx.x >> 2);
  const int kq = TRANS ? (threadIdx.x >> 6) : (threadIdx.x & 3);
  const int row = blockIdx.y * PT + r, k0 = blockIdx.x * PT + 16 * kq;
  const int le = lexp[row];
  int vh[16], vl[16], vs[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const size_t gi = TRANS ? static_cast<size_t>(k0 + j) * rows + row
                            : static_cast<size_t>(row) * kdim + k0 + j;
    vh[j] = mh[gi];
    vl[j] = ml[gi];
    vs[j] = e[gi] + le;
  }
  uint8_t* const dst[3] = {hi, lo, hs};
  const size_t plane = static_cast<size_t>(rows) * kdim;
  const size_t at = static_cast<size_t>(row) * kdim + k0;
  for (int l = 0; l < M.n; ++l) {
    const int* pw = tbl_s + l * TABLE_LEN;
    const int p = M.ps[l], s = M.split_s[l];
    const size_t o = l * plane + at;
    switch (M.kind[l]) {
      case KIND_SQUARE:
        modulus_parts<KIND_SQUARE>(vh, vl, vs, p, s, pw, dst, o);
        break;
      case KIND_KARATSUBA:
        modulus_parts<KIND_KARATSUBA>(vh, vl, vs, p, s, pw, dst, o);
        break;
      default:
        modulus_parts<KIND_INT8>(vh, vl, vs, p, s, pw, dst, o);
    }
  }
}

__global__ void mma_probe_kernel(const uint8_t* a, const uint8_t* bt, int k, int* exact,
                                 float* chained) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  int acc[4] = {0, 0, 0, 0};
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < k; k0 += 32) {
    const uint8_t* pa = a + static_cast<size_t>(g) * k + k0 + 4 * t;
    const uint8_t* pb = bt + static_cast<size_t>(g) * k + k0 + 4 * t;
    const uint32_t af[4] = {
        *reinterpret_cast<const uint32_t*>(pa),
        *reinterpret_cast<const uint32_t*>(pa + 8 * static_cast<size_t>(k)),
        *reinterpret_cast<const uint32_t*>(pa + 16),
        *reinterpret_cast<const uint32_t*>(pa + 8 * static_cast<size_t>(k) + 16)};
    const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(pb),
                            *reinterpret_cast<const uint32_t*>(pb + 16)};
    mma_k32_exact(acc, af, bf);
    float d[4];
    mma_e4m3(d, af, bf, c);
#pragma unroll
    for (int q = 0; q < 4; ++q) c[q] = d[q];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = (g + 8 * (q >> 1)) * 8 + 2 * t + (q & 1);
    exact[idx] = acc[q];
    chained[idx] = c[q];
  }
}

// e4m3 m64n8k32 into a fresh fragment (scale-d = 0) and chained onto d.
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db, int chain) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.f32.e4m3.e4m3 {%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(chain));
}

// One warpgroup runs the core's k32 step (a fresh e4m3 m64n8k32 fragment,
// added into f32: promotion every KC = 1 step) and, beside it, one f32
// accumulator chained across every step, over A (64 x k) and B^T (8 x k)
// laid out in shared memory as the core's TMA lays them (128-byte swizzle).
// `first_bad` gets the first k32 step at which the chain left the exact
// sum (-1: never).
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const uint8_t* a, const uint8_t* bt, int k, int* exact, float* chained,
                   int* first_bad) {
  __shared__ uint8_t raw[1024 + 72 * 128];
  const uint32_t base = (hopper::smem_addr(raw) + 1023) & ~1023u;
  uint8_t* tile = raw + (base - hopper::smem_addr(raw));  // A rows 0..63, B rows 64..71
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
  int bad[4] = {-1, -1, -1, -1};
  for (int k0 = 0; k0 < k; k0 += 128) {
    __syncthreads();  // the previous chunk's products are done
    for (int i = threadIdx.x; i < 72 * 8; i += 128) {
      const int r = i >> 3, ch = i & 7;
      const uint8_t* src = r < 64 ? a + static_cast<size_t>(r) * k
                                  : bt + static_cast<size_t>(r - 64) * k;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + 16 * ch < k) v = *reinterpret_cast<const uint4*>(src + k0 + 16 * ch);
      *reinterpret_cast<uint4*>(tile + r * 128 + 16 * (ch ^ (r & 7))) = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    for (int kk = 0; kk < 128 && k0 + kk < k; kk += 32) {
      const uint64_t da = hopper::desc_k128(base + kk);
      const uint64_t db = hopper::desc_k128(base + 64 * 128 + kk);
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      hopper::wgmma_fence();
      wgmma_n8(f, da, db, 0);
      wgmma_n8(c, da, db, 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      const int step = (k0 + kk) / 32;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q] = __fadd_rn(acc[q], f[q]);
        if (bad[q] < 0 && c[q] != acc[q]) bad[q] = step;
      }
    }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = (16 * w + (lane >> 2) + 8 * (q >> 1)) * 8 + 2 * (lane & 3) + (q & 1);
    exact[idx] = __float2int_rn(acc[q]);
    chained[idx] = c[q];
    first_bad[idx] = bad[q];
  }
}

}  // namespace

extern "C" {

// Launch the residue prologue on `stream`: the K-major parts (N, rows, kdim)
// of one operand into hi, lo, hs (fp8 families; hs planes of square moduli
// left unwritten) or hi (int8; lo = hs = NULL), from its raw frames mh, ml, e
// (rows x kdim, or kdim x rows when trans != 0), the pairing exponents lexp
// (rows) and the 2^e-mod-p tables (N x 1024), all device pointers; rows and
// kdim multiples of 64. The moduli constants are host arrays of num_moduli
// entries (inv: num_moduli x num_moduli, row-major). Returns the CUDA error
// of the launch (0 on success).
int raw_parts_launch(const int* mh, const int* ml, const int* e, const int* lexp, const int* tbl,
                     uint8_t* hi, uint8_t* lo, uint8_t* hs, int rows, int kdim, int trans,
                     int num_moduli, int device, const int* ps, const int* split_s,
                     const int* kind, const int* radix_order, const int* radix_ps,
                     const int* inv, const double* weights, void* stream) {
  if (num_moduli < 1 || num_moduli > MAXN || rows <= 0 || kdim <= 0 || rows % PT ||
      kdim % PT || rows / PT > 65535 || !hi)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = kind[0] == KIND_INT8;
  if (int8 ? (lo || hs) : !(lo && hs)) return static_cast<int>(cudaErrorInvalidValue);
  const Moduli mod =
      make_moduli(num_moduli, ps, split_s, kind, radix_order, radix_ps, inv, weights);
  const size_t smem = static_cast<size_t>(num_moduli) * TABLE_LEN * sizeof(int);
  return on_device(device, [&]() {
    auto kern = trans ? raw_parts_kernel<true> : raw_parts_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(kdim / PT, rows / PT), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        mh, ml, e, lexp, tbl, hi, lo, hs, rows, kdim, mod);
    return cudaGetLastError();
  });
}

// Launch the GEMM core (hopper_gemm.cuh) on `stream`: C (m x n, f64) from the
// K-major parts of A ((N, m, k): a_hi, a_lo, a_hs, int8 in a_hi with a_lo =
// a_hs = NULL) and of B ((N, n, k), the same way), lmu (m), lnu (n), an
// (N, m, n) int16 scratch; m, n, k multiples of (128, 128, 128). Given
// out = NULL, the scratch gets the int16 Garner digits (radix order)
// instead of C. Returns the CUDA error (0 on success).
int ozmm_fused_raw_launch(const uint8_t* a_hi, const uint8_t* a_lo, const uint8_t* a_hs,
                          const uint8_t* b_hi, const uint8_t* b_lo, const uint8_t* b_hs,
                          const int* lmu, const int* lnu, int16_t* res, double* out, int m,
                          int n, int k, int num_moduli, int device, const int* ps,
                          const int* split_s, const int* kind, const int* radix_order,
                          const int* radix_ps, const int* inv, const double* weights,
                          void* stream) {
  if (num_moduli < 1 || num_moduli > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* const a[3] = {a_hi, a_lo, a_hs};
  const uint8_t* const b[3] = {b_hi, b_lo, b_hs};
  return hopper::gemm_core_launch(
      a, b, lmu, lnu, res, out, m, n, k,
      make_moduli(num_moduli, ps, split_s, kind, radix_order, radix_ps, inv, weights), device,
      static_cast<cudaStream_t>(stream));
}

// The core's promotion interval in k32 steps (hopper::KC).
int gemm_core_kc() { return hopper::KC; }

// One warp runs the K3/K4 k32 FP8 step over a (16 x k) e4m3 A (row-major)
// and B^T (8 x k, row-major): `exact` gets the int32 product as the kernel
// forms it, `chained` the product of a plain f32 accumulation across steps.
int mma_probe_launch(const uint8_t* a, const uint8_t* bt, int k, int* exact, float* chained,
                     int device, void* stream) {
  if (k <= 0 || k % 32) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&]() {
    mma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, bt, k, exact, chained);
    return cudaGetLastError();
  });
}

// One warpgroup runs the GEMM core's promoted wgmma step and a chained f32
// accumulation over a (64 x k) e4m3 A and B^T (8 x k), both row-major with
// k a multiple of 32: `exact` (64 x 8 int32) gets the promoted product,
// `chained` (f32) the chain's, `first_bad` the first k32 step where the
// chain left the exact sum, or -1.
int wgmma_probe_launch(const uint8_t* a, const uint8_t* bt, int k, int* exact, float* chained,
                       int* first_bad, int device, void* stream) {
  if (k <= 0 || k % 32) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&]() {
    wgmma_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(a, bt, k, exact,
                                                                          chained, first_bad);
    return cudaGetLastError();
  });
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
