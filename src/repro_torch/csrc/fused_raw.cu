// The whole Ozaki-II emulated DGEMM from raw frames in one kernel, for Hopper
// (sm_90a). Replaces repro/kernels/fused/kernel.py::ozmm_fused_raw (body
// _kernel_raw, with _residue_tile, _split_fp8, _mma_fp8/_dot_i32 and
// _finalize), and computes what it computes:
//
//   per operand element, x = (mh*2^26 + ml) * 2^e (ops.decompose_raw) scaled
//   by the pairing exponent (lmu per row of A, lnu per column of B) and
//   truncated -> centred residue mod p -> e4m3 parts (or int8) -> the
//   eq. (8)/(12) products (or the single int8 product) -> combine -> balanced
//   Garner digits -> Kahan f64 sum -> ldexp_wide -> C.
//
// Schedule (fused_common.cuh, shared with K2 = fused_parts.cu): one block of
// 8 warps per 64 x 64 output tile, the moduli in the OUTER loop, since the
// TPU schedule's 3N resident int32 accumulator tiles (2.25 MiB at N = 12)
// fit no SM. Here, for each modulus the block walks k in steps of 64 and
// rebuilds the residue parts of its A and B k-tiles in shared memory (B
// stored k-contiguous per column for the .col operand); the products, the
// per-modulus int16 residue tile (N x 64 x 64 x 2 B, 96 KiB at N = 12) and
// the Garner / Kahan / ldexp_wide epilogue are the shared code. Every digit
// plane is an exact integer, so any schedule gives the bits of the
// reference (docs/kernels.md, "Garner accumulation").
//
// Exactness. FP8 products use mma.sync m16n8k32 e4m3 with f32 accumulation,
// each k32 step started from a ZERO fragment, converted with __float2int_rn
// and added to int32: one step sums at most 32*16*16 = 2^13 in magnitude, so
// it is exact even if Hopper's FP8 accumulator keeps fewer than 24 bits.
// int8 products use the s8 mma with s32 accumulation (exact). The Kahan
// term x*w - c is ONE fused multiply-add (__fma_rn), the rounding of the
// reference on the CPU, where XLA contracts it; every other f64 step is
// spelled __dadd_rn/__dsub_rn/__dmul_rn, and the library is built without
// --use_fast_math and with --fmad=false, so nothing else contracts.
//
// Bound. The work is 3N * 2mnk FP8 operations (N * 2mnk int8 for the int8
// family) against the card's dense FP8/int8 tensor rate, plus the integer
// residue work: every block recomputes the residues of its whole A row-panel
// and B column-panel for every modulus, N*mnk*(1/64 + 1/64) residues in all,
// each a few dozen integer instructions with three runtime `% p`. That
// integer work, not the tensor cores, bounds this design; it keeps the
// residues out of device memory (only the raw frames are read) at that
// price. Barrett reduction and residues hoisted out of the per-tile
// recompute, then wgmma/TMA, are the queued work (ROADMAP).

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

constexpr int TABLE_LEN = 1024;  // moduli.POW2_TABLE_LEN
constexpr int MANT_SPLIT = 26;

// Centred residue mod p of trunc(2^sc * (mh*2^26 + ml)) (_residue_tile):
// negative sc truncates by shifts of the magnitudes, the high-limb shift
// clipped to 31 (a shift of 32 or more is UB); positive sc multiplies by
// 2^sc mod p from the table, indices clipped to it; the sign comes back last.
__device__ __forceinline__ int residue(int mh, int ml, int sc, int p, const int* pw) {
  const unsigned amh = static_cast<unsigned>(abs(mh)), aml = static_cast<unsigned>(abs(ml));
  const int sg = mh != 0 ? (mh > 0 ? 1 : -1) : (ml > 0) - (ml < 0);
  const int t = max(-sc, 0);
  const int tl = min(t, MANT_SPLIT);
  const int th = min(max(t - MANT_SPLIT, 0), 31);
  const int sp = max(sc, 0);
  const unsigned wh = static_cast<unsigned>(pw[min(MANT_SPLIT - tl + sp, TABLE_LEN - 1)]);
  const unsigned wl = static_cast<unsigned>(pw[min(sp, TABLE_LEN - 1)]);
  const unsigned up = static_cast<unsigned>(p);
  const int r = static_cast<int>((((amh >> th) % up) * wh + ((aml >> tl) % up) * wl) % up);
  return ozaki::cmod(sg * r, p);
}

// Residue -> parts at dst, dst + PART, dst + 2*PART (_split_fp8): (hi, lo) by
// a round-half-even split for a square modulus p = s^2, (hi, lo, hi + lo) by a
// ceil split for a Karatsuba modulus, the residue itself for int8.
template <int KIND>
__device__ __forceinline__ void store_parts(uint8_t* dst, int r, int s) {
  if constexpr (KIND == KIND_INT8) {
    dst[0] = static_cast<uint8_t>(static_cast<int8_t>(r));
  } else if constexpr (KIND == KIND_SQUARE) {
    const int hi = ozaki::split_square_hi(r, s);
    dst[0] = ozaki::e4m3(hi);
    dst[PART] = ozaki::e4m3(r - s * hi);
  } else {
    const int hi = ozaki::split_karatsuba_hi(r);
    const int lo = r - 16 * hi;
    dst[0] = ozaki::e4m3(hi);
    dst[PART] = ozaki::e4m3(lo);
    dst[2 * PART] = ozaki::e4m3(hi + lo);
  }
}

struct Operands {
  const int* mh_a; const int* ml_a; const int* e_a; const int* lmu;
  const int* mh_b; const int* ml_b; const int* e_b; const int* lnu;
  int k, n;  // contraction length, columns of B / C
};

// One modulus over the whole contraction: residue parts of each k-tile built
// in shared memory, products into registers, then the centred residue of the
// tile's product into res (BM x BN int16).
template <int KIND>
__device__ __forceinline__ void modulus_pass(const Operands& op, int row0, int col0, int p,
                                             int s, const int* tbl_s, uint8_t* a_s,
                                             uint8_t* b_s, int16_t* res) {
  int acc[kAccs<KIND>][2][2][4] = {};
  for (int k0 = 0; k0 < op.k; k0 += BK) {
    __syncthreads();  // the table is loaded; the previous k-tile's parts are consumed
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const size_t gi = static_cast<size_t>(row0 + r) * op.k + k0 + c;
      const int x = residue(op.mh_a[gi], op.ml_a[gi], op.e_a[gi] + op.lmu[row0 + r], p, tbl_s);
      store_parts<KIND>(a_s + r * LDS + c, x, s);
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      const size_t gi = static_cast<size_t>(k0 + kk) * op.n + col0 + c;
      const int x = residue(op.mh_b[gi], op.ml_b[gi], op.e_b[gi] + op.lnu[col0 + c], p, tbl_s);
      store_parts<KIND>(b_s + c * LDS + kk, x, s);
    }
    __syncthreads();
    mma_tile<KIND>(acc, a_s, b_s);
  }
  store_residue<KIND>(acc, p, s, res);
}

__global__ void __launch_bounds__(THREADS)
fused_raw_kernel(Operands op, const int* __restrict__ tbl, double* __restrict__ out,
                 const __grid_constant__ Moduli mod) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Moduli M;
  copy_moduli(M, mod);
  __syncthreads();
  const int n_mod = M.n;
  int16_t* res_s = reinterpret_cast<int16_t*>(smem);                      // [N][BM][BN]
  int* tbl_s = reinterpret_cast<int*>(smem + n_mod * BM * BN * 2);        // [TABLE_LEN]
  uint8_t* a_s = reinterpret_cast<uint8_t*>(tbl_s + TABLE_LEN);           // [3][BM][LDS]
  uint8_t* b_s = a_s + 3 * PART;                                          // [3][BN][LDS]
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  for (int l = 0; l < n_mod; ++l) {
    for (int i = threadIdx.x; i < TABLE_LEN; i += THREADS) tbl_s[i] = tbl[l * TABLE_LEN + i];
    int16_t* res = res_s + l * BM * BN;
    const int p = M.ps[l], s = M.split_s[l];
    switch (M.kind[l]) {
      case KIND_SQUARE:
        modulus_pass<KIND_SQUARE>(op, row0, col0, p, s, tbl_s, a_s, b_s, res);
        break;
      case KIND_KARATSUBA:
        modulus_pass<KIND_KARATSUBA>(op, row0, col0, p, s, tbl_s, a_s, b_s, res);
        break;
      default:
        modulus_pass<KIND_INT8>(op, row0, col0, p, s, tbl_s, a_s, b_s, res);
    }
  }
  __syncthreads();

  finalize(M, res_s, op.lmu, op.lnu, out, row0, col0, op.n);
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

}  // namespace

extern "C" {

// Launch on `stream`: C (m x n, f64) from the raw frames of A (m x k) and
// B (k x n), lmu (m), lnu (n) and the 2^e-mod-p tables (N x 1024), all int32
// device pointers; the moduli constants are host arrays of num_moduli
// entries (inv: num_moduli x num_moduli, row-major). Returns the CUDA error
// of the launch (0 on success).
int ozmm_fused_raw_launch(const int* mh_a, const int* ml_a, const int* e_a, const int* lmu,
                          const int* mh_b, const int* ml_b, const int* e_b, const int* lnu,
                          const int* tbl, double* out, int m, int n, int k, int num_moduli,
                          int device, const int* ps, const int* split_s, const int* kind,
                          const int* radix_order, const int* radix_ps, const int* inv,
                          const double* weights, void* stream) {
  if (num_moduli < 1 || num_moduli > MAXN || m <= 0 || n <= 0 || k <= 0 || m % BM ||
      n % BN || k % BK || m / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Moduli mod =
      make_moduli(num_moduli, ps, split_s, kind, radix_order, radix_ps, inv, weights);
  const Operands op{mh_a, ml_a, e_a, lmu, mh_b, ml_b, e_b, lnu, k, n};
  const size_t smem = static_cast<size_t>(num_moduli) * BM * BN * sizeof(int16_t) +
                      TABLE_LEN * sizeof(int) + 6 * PART;
  return on_device(device, [&]() {
    cudaError_t err = cudaFuncSetAttribute(
        fused_raw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fused_raw_kernel<<<dim3(n / BN, m / BM), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        op, tbl, out, mod);
    return cudaGetLastError();
  });
}

// One warp runs the kernel's k32 FP8 step over a (16 x k) e4m3 A (row-major)
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

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
