// The requant + Garner pass of the phase-split Ozaki-II pipeline, for Hopper
// (sm_90a). Replaces repro/kernels/crt_reconstruct/kernel.py::requant_garner
// (bodies _kernel_fp8 and _kernel_int8, with the helpers _centered, _cmod,
// _combine and _garner), and computes what they compute:
//
//   per output element and modulus l, the residue products of the GEMM
//   schedule (c1, c2, c3 f32 planes of the fp8 families, exact integers;
//   or one int32 plane for int8) -> the centred residue of A'B' mod p_l
//   (eq. (12) for a square modulus, eq. (9) for a Karatsuba modulus, cmod
//   for int8) -> balanced Garner mixed-radix digits in radix order -> int16
//   digits (N, m, n).
//
// One thread per element (grid-stride), all N moduli in registers: digit i
// reads the residue of ps[radix_order[i]]. The integer helpers are those of
// K1/K2 (ozaki_int.cuh, bitwise against the reference on the card), so the
// digit planes equal the fused kernels' and the core route's. The f64
// epilogue (Kahan sum and ldexp_wide) stays a PyTorch function, as the
// reference leaves it to XLA (crt_reconstruct/ops.py::reconstruct_f64).
//
// Bound: bytes. Each element reads 3N f32 (N int32) and writes N int16, read
// and written once, coalesced; the integer work (a few runtime mods per
// modulus and N(N-1)/2 Garner steps) stays below the memory time.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

template <bool INT8>
__global__ void __launch_bounds__(THREADS)
requant_garner_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
                      const float* __restrict__ c3, const int* __restrict__ ci,
                      int16_t* __restrict__ out, long long count,
                      const __grid_constant__ Moduli mod) {
  __shared__ Moduli M;
  copy_moduli(M, mod);
  __syncthreads();
  const int n_mod = M.n;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < count;
       i += stride) {
    int cs[MAXN];
    for (int l = 0; l < n_mod; ++l) {
      const long long j = l * count + i;
      if constexpr (INT8) {
        cs[l] = ozaki::cmod(ci[j], M.ps[l]);
      } else {
        // exact integers |c| <= 2^24: the conversion is astype(int32)
        cs[l] = ozaki::combine(__float2int_rz(c1[j]), __float2int_rz(c2[j]),
                               __float2int_rz(c3[j]), M.ps[l], M.kind[l] == KIND_SQUARE,
                               M.split_s[l]);
      }
    }
    int digits[MAXN];
    for (int d = 0; d < n_mod; ++d) {
      digits[d] = ozaki::garner_digit(cs[M.radix_order[d]], M.radix_ps[d], digits, &M.inv[d],
                                      MAXN, d);
      out[d * count + i] = static_cast<int16_t>(digits[d]);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: the int16 digit stack out (N x count, radix order)
// from the product planes, each (N x count) with count = m * n: c1, c2, c3
// f32 for the fp8 families (ci = NULL), or ci int32 for int8 (c1 = c2 = c3
// = NULL); all device pointers. The moduli constants are host arrays of
// num_moduli entries (inv: num_moduli x num_moduli, row-major). Returns the
// CUDA error of the launch (0 on success).
int requant_garner_launch(const float* c1, const float* c2, const float* c3, const int* ci,
                          int16_t* out, long long count, int num_moduli, int device,
                          const int* ps, const int* split_s, const int* kind,
                          const int* radix_order, const int* radix_ps, const int* inv,
                          const double* weights, void* stream) {
  const bool int8 = ci != nullptr;
  if (num_moduli < 1 || num_moduli > MAXN || count <= 0 ||
      (int8 ? (c1 || c2 || c3) : !(c1 && c2 && c3)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Moduli mod =
      make_moduli(num_moduli, ps, split_s, kind, radix_order, radix_ps, inv, weights);
  return on_device(device, [&]() {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long blocks = (count + THREADS - 1) / THREADS;
    const int grid = static_cast<int>(blocks < 8LL * sms ? blocks : 8LL * sms);
    auto s = static_cast<cudaStream_t>(stream);
    if (int8) {
      requant_garner_kernel<true><<<grid, THREADS, 0, s>>>(c1, c2, c3, ci, out, count, mod);
    } else {
      requant_garner_kernel<false><<<grid, THREADS, 0, s>>>(c1, c2, c3, ci, out, count, mod);
    }
    return cudaGetLastError();
  });
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
