// The Ozaki-II emulated DGEMM from prepared residue parts, for Hopper
// (sm_90a). Replaces repro/kernels/fused/kernel.py::ozmm_fused_parts
// (bodies _kernel_parts_fp8 and _kernel_parts_int8, with _mma_fp8/_dot_i32
// and _finalize), and computes what they compute:
//
//   per modulus l, the e4m3 parts of A (hi, lo, hs stacks, (N, m, k)) and of
//   B ((N, k, n)) -> the eq. (8)/(12) products (or the single product of the
//   int8 stacks) -> combine -> balanced Garner digits -> Kahan f64 sum ->
//   ldexp_wide(., -(lmu_i + lnu_j)) -> C; or the int16 Garner digit stack
//   (N, m, n) instead of C (the reference's reconstruct="xla"). Any k up to
//   2^21 for the fp8 families, 2^16 for int8, as K1.
//
// The parts are those of fast-mode plans (core/plan.py, stacked by
// kernels/common.py::stack_parts): the quantization was done once per
// operand, so this kernel only streams parts through the tensor cores.
//
// Two steps on the stream, both hand-written:
//
// 1. transpose_parts_kernel: B's (N, k, n) stacks, N-major as the plans keep
//    them, to K-major (N, n, k), once per call: wgmma takes 8-bit operands
//    only K-major. 64 x 64-byte tiles through shared memory, 16-byte loads
//    and stores (byte by byte at ragged edges, which the phase-split
//    pipeline's unpadded plans have); square moduli's hs planes are neither
//    read nor written.
//    A's (N, m, k) stacks are K-major already and are read in place.
// 2. The GEMM core of hopper_gemm.cuh (shared with K1): a TMA ring of
//    128-byte-swizzled k-tiles, wgmma m64n64k32 from shared memory with the
//    FP8 products promoted into f32 every k32 step, the per-modulus residues
//    into an (N, m, n) scratch, then finalize on each element.
//
// Bound. 3N * 2mnk FP8 operations (N * 2mnk int8) against the dense tensor
// rate: 20.0 ms at 8192^3, N = 12. Bytes: the parts read once (2 per square,
// 3 per Karatsuba modulus and element of A and B) and the f64 C written,
// plus the transpose (B's parts read and written once more), the residue
// scratch (2N bytes an element of C) and, in L2, 3N * mnk * (1/128 +
// 1/128) for the core's 128 x 128 cluster tiles. The stacks must be 16-byte
// aligned (TMA). The core is bound by each warpgroup's alternation of wgmma
// and promotion adds (hopper_gemm.cuh), not by the tensor rate.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_gemm.cuh"

namespace {

using namespace fused;

constexpr int TT = 64;        // transpose tile: 64 k rows x 64 columns (bytes)
constexpr int TLD = TT + 16;  // shared row stride: 16-byte aligned rows

// One 64 x 64-byte tile of one plane: src (k, n) bytes, dst (n, k) bytes.
// Each thread loads 16 bytes of a k row, then gathers 16 k bytes of one
// column from shared memory and stores them as one 16-byte word. A tile at
// a ragged edge, or of a plane whose k or n is no multiple of 16 (the
// phase-split pipeline's unpadded plans), is copied byte by byte, masked.
__global__ void __launch_bounds__(THREADS)
transpose_parts_kernel(const uint8_t* __restrict__ s0, const uint8_t* __restrict__ s1,
                       const uint8_t* __restrict__ s2, uint8_t* __restrict__ d0,
                       uint8_t* __restrict__ d1, uint8_t* __restrict__ d2, int k, int n,
                       const __grid_constant__ Moduli mod) {
  __shared__ __align__(16) uint8_t tile[TT * TLD];
  const int l = blockIdx.z / 3, q = blockIdx.z % 3;
  const int kind = mod.kind[l];
  if (q >= (kind == KIND_KARATSUBA ? 3 : (kind == KIND_SQUARE ? 2 : 1))) return;
  const uint8_t* src = (q == 0 ? s0 : q == 1 ? s1 : s2) + static_cast<size_t>(l) * k * n;
  uint8_t* dst = (q == 0 ? d0 : q == 1 ? d1 : d2) + static_cast<size_t>(l) * k * n;
  const int k0 = blockIdx.y * TT, c0 = blockIdx.x * TT;
  if (k0 + TT > k || c0 + TT > n || k % 16 || n % 16) {
    for (int i = threadIdx.x; i < TT * TT; i += THREADS) {
      const int kr = i / TT, col = i % TT;
      if (k0 + kr < k && c0 + col < n)
        tile[kr * TLD + col] = src[static_cast<size_t>(k0 + kr) * n + c0 + col];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TT * TT; i += THREADS) {
      const int col = i / TT, kr = i % TT;
      if (c0 + col < n && k0 + kr < k)
        dst[static_cast<size_t>(c0 + col) * k + k0 + kr] = tile[kr * TLD + col];
    }
    return;
  }
  const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 16;
  *reinterpret_cast<uint4*>(tile + r * TLD + c) =
      *reinterpret_cast<const uint4*>(src + static_cast<size_t>(k0 + r) * n + c0 + c);
  __syncthreads();
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    w[j >> 2] |= static_cast<uint32_t>(tile[(c + j) * TLD + r]) << (8 * (j & 3));
  *reinterpret_cast<uint4*>(dst + static_cast<size_t>(c0 + r) * k + k0 + c) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

extern "C" {

// Launch the B transpose on `stream`: the (N, k, n) part stacks s_hi, s_lo,
// s_hs (int8: s_hi only, the others NULL) into (N, n, k) stacks d_*; square
// moduli's hs planes untouched; any k and n, all pointers 16-byte aligned.
// `kind` is the host array of the moduli kinds. Returns the CUDA error (0 on
// success).
int transpose_parts_launch(const uint8_t* s_hi, const uint8_t* s_lo, const uint8_t* s_hs,
                           uint8_t* d_hi, uint8_t* d_lo, uint8_t* d_hs, int k, int n,
                           int num_moduli, int device, const int* ps, const int* split_s,
                           const int* kind, const int* radix_order, const int* radix_ps,
                           const int* inv, const double* weights, void* stream) {
  if (num_moduli < 1 || num_moduli > MAXN || k <= 0 || n <= 0 || (k + TT - 1) / TT > 65535 ||
      !s_hi || !d_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = kind[0] == KIND_INT8;
  if (!int8 && !(s_lo && s_hs && d_lo && d_hs)) return static_cast<int>(cudaErrorInvalidValue);
  const Moduli mod =
      make_moduli(num_moduli, ps, split_s, kind, radix_order, radix_ps, inv, weights);
  return on_device(device, [&]() {
    const dim3 grid((n + TT - 1) / TT, (k + TT - 1) / TT, 3 * num_moduli);
    transpose_parts_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        s_hi, s_lo, s_hs, d_hi, d_lo, d_hs, k, n, mod);
    return cudaGetLastError();
  });
}

// Launch the GEMM core (hopper_gemm.cuh) on `stream`: C (m x n, f64) from the
// K-major parts of A ((N, m, k): a_hi, a_lo, a_hs, int8 in a_hi with a_lo =
// a_hs = NULL) and of B ((N, n, k), transpose_parts's output), lmu (m), lnu
// (n), an (N, m, n) int16 scratch; m, n, k multiples of (128, 128, 128), the
// stacks 16-byte aligned. Given out = NULL, the scratch gets the int16
// Garner digits (radix order) instead of C. Returns the CUDA error (0 on
// success).
int ozmm_fused_parts_launch(const uint8_t* a_hi, const uint8_t* a_lo, const uint8_t* a_hs,
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

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
