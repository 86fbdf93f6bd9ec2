// The Ozaki-II emulated DGEMM from prepared residue parts in one kernel, for
// Hopper (sm_90a). Replaces repro/kernels/fused/kernel.py::ozmm_fused_parts
// (bodies _kernel_parts_fp8 and _kernel_parts_int8, with _mma_fp8/_dot_i32
// and _finalize), and computes what they compute:
//
//   per modulus l, the e4m3 parts of A (hi, lo, hs stacks, (N, m, k)) and of
//   B ((N, k, n)) -> the eq. (8)/(12) products (or the single product of the
//   int8 stacks) -> combine -> balanced Garner digits -> Kahan f64 sum ->
//   ldexp_wide(., -(lmu_i + lnu_j)) -> C.
//
// The parts are those of fast-mode plans (core/plan.py, stacked by
// kernels/common.py::stack_parts): the quantization was done once per
// operand, so this kernel only streams parts through the tensor cores. A
// square modulus reads its hi and lo parts and never the zero-filled hs
// stack.
//
// Schedule: fused_common.cuh, shared with K1 (fused_raw.cu): one block of 8
// warps per 64 x 64 output tile, the moduli in the outer loop, 3 int32
// accumulators in registers through the k loop, one int16 residue tile per
// modulus in shared memory, then Garner / Kahan / ldexp_wide. Per k-tile,
// each thread copies 16 bytes of each A part (row-major, as stored) and a
// 4 x 4 byte block of each B part, which it transposes in registers so that
// B sits k-contiguous per column for the .col operand of mma.sync. B stacks
// therefore arrive in the reference's (N, k, n) layout, with no host copy.
//
// Exactness is K1's: each k32 FP8 step starts from a zero f32 fragment and is
// converted to int32 (one step sums at most 32 * 16 * 16 = 2^13);
// int8 uses the s8 mma with s32 accumulation; the Kahan term is __fma_rn and
// the library is built with --fmad=false.
//
// Bound. 3N * 2mnk FP8 operations (N * 2mnk int8) against the dense tensor
// rate, and the part bytes, 3N(mk + kn), read once. This simple design reads
// each A tile once per column block and each B tile once per row block
// (64 x 64 tiles, no multi-buffering, mma.sync rather than wgmma), so L2 and
// device-memory traffic, not the tensor cores, bound it; wgmma, TMA and a
// pipelined ring of tiles are the queued work (ROADMAP).

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

struct Stacks {
  const uint8_t* a[3];  // A's hi, lo, hs stacks, (N, m, k) bytes; int8: a[0] only
  const uint8_t* b[3];  // B's stacks, (N, k, n)
  const int* lmu;       // (m)
  const int* lnu;       // (n)
  int m, k, n;
};

// The k-tile (rows row0.., k bytes k0..k0+63) of one A part into dst
// ([BM][LDS]): 64 rows x 4 threads, 16 bytes each.
__device__ __forceinline__ void load_a_tile(uint8_t* dst, const uint8_t* src, int k, int row0,
                                            int k0) {
  const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 16;
  *reinterpret_cast<uint4*>(dst + r * LDS + c) =
      *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * k + k0 + c);
}

// The k-tile (k rows k0.., columns col0..col0+63) of one B part into dst
// ([BN][LDS], k-contiguous per column): each thread reads 4 rows of 4
// columns and writes 4 columns of 4 k bytes. A warp covers 4 rows x 32
// bytes per load (whole 32-byte sectors).
__device__ __forceinline__ void load_b_tile(uint8_t* dst, const uint8_t* src, int n, int k0,
                                            int col0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cb = (lane & 7) + 8 * (warp & 1);    // columns 4cb .. 4cb+3
  const int kb = (lane >> 3) + 4 * (warp >> 1);  // k rows 4kb .. 4kb+3
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = *reinterpret_cast<const uint32_t*>(src + static_cast<size_t>(k0 + 4 * kb + i) * n +
                                              col0 + 4 * cb);
  }
  store_b_transposed(dst, w, 4 * cb, 4 * kb);
}

// One modulus over the whole contraction: its parts of each k-tile copied to
// shared memory, products into registers, then the centred residue of the
// tile's product into res (BM x BN int16).
template <int KIND>
__device__ __forceinline__ void modulus_pass(const Stacks& st, int l, int row0, int col0, int p,
                                             int s, uint8_t* a_s, uint8_t* b_s, int16_t* res) {
  const size_t a_off = static_cast<size_t>(l) * st.m * st.k;
  const size_t b_off = static_cast<size_t>(l) * st.k * st.n;
  int acc[kAccs<KIND>][2][2][4] = {};
  for (int k0 = 0; k0 < st.k; k0 += BK) {
    __syncthreads();  // the previous k-tile's parts are consumed
#pragma unroll
    for (int q = 0; q < kParts<KIND>; ++q) {
      load_a_tile(a_s + q * PART, st.a[q] + a_off, st.k, row0, k0);
      load_b_tile(b_s + q * PART, st.b[q] + b_off, st.n, k0, col0);
    }
    __syncthreads();
    mma_tile<KIND>(acc, a_s, b_s);
  }
  store_residue<KIND>(acc, p, s, res);
}

__global__ void __launch_bounds__(THREADS)
fused_parts_kernel(Stacks st, double* __restrict__ out, const __grid_constant__ Moduli mod) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Moduli M;
  copy_moduli(M, mod);
  __syncthreads();
  const int n_mod = M.n;
  int16_t* res_s = reinterpret_cast<int16_t*>(smem);  // [N][BM][BN]
  uint8_t* a_s = smem + n_mod * BM * BN * 2;          // [3][BM][LDS]
  uint8_t* b_s = a_s + 3 * PART;                      // [3][BN][LDS]
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  for (int l = 0; l < n_mod; ++l) {
    int16_t* res = res_s + l * BM * BN;
    const int p = M.ps[l], s = M.split_s[l];
    switch (M.kind[l]) {
      case KIND_SQUARE:
        modulus_pass<KIND_SQUARE>(st, l, row0, col0, p, s, a_s, b_s, res);
        break;
      case KIND_KARATSUBA:
        modulus_pass<KIND_KARATSUBA>(st, l, row0, col0, p, s, a_s, b_s, res);
        break;
      default:
        modulus_pass<KIND_INT8>(st, l, row0, col0, p, s, a_s, b_s, res);
    }
  }
  __syncthreads();

  finalize(M, res_s, st.lmu, st.lnu, out, row0, col0, st.n);
}

}  // namespace

extern "C" {

// Launch on `stream`: C (m x n, f64) from the part stacks of A ((N, m, k)
// bytes: hi, lo, hs for the fp8 families, hs unread for square moduli; the
// int8 stack in a_hi with a_lo = a_hs = NULL) and of B ((N, k, n), the same
// way), lmu (m) and lnu (n) int32, all device pointers, the stacks 16-byte
// aligned; the moduli constants are host arrays of num_moduli entries (inv:
// num_moduli x num_moduli, row-major). Returns the CUDA error of the launch
// (0 on success).
int ozmm_fused_parts_launch(const uint8_t* a_hi, const uint8_t* a_lo, const uint8_t* a_hs,
                            const uint8_t* b_hi, const uint8_t* b_lo, const uint8_t* b_hs,
                            const int* lmu, const int* lnu, double* out, int m, int n, int k,
                            int num_moduli, int device, const int* ps, const int* split_s,
                            const int* kind, const int* radix_order, const int* radix_ps,
                            const int* inv, const double* weights, void* stream) {
  if (num_moduli < 1 || num_moduli > MAXN || m <= 0 || n <= 0 || k <= 0 || m % BM ||
      n % BN || k % BK || m / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Moduli mod =
      make_moduli(num_moduli, ps, split_s, kind, radix_order, radix_ps, inv, weights);
  const Stacks st{{a_hi, a_lo, a_hs}, {b_hi, b_lo, b_hs}, lmu, lnu, m, k, n};
  const size_t smem = static_cast<size_t>(num_moduli) * BM * BN * sizeof(int16_t) + 6 * PART;
  return on_device(device, [&]() {
    cudaError_t err = cudaFuncSetAttribute(
        fused_parts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fused_parts_kernel<<<dim3(n / BN, m / BM), THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(st, out, mod);
    return cudaGetLastError();
  });
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
