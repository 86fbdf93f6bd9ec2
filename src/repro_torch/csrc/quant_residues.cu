// The residue quantization pass of the phase-split Ozaki-II pipeline, for
// Hopper (sm_90a). Replaces repro/kernels/quant_residues/kernel.py::
// quant_residues (bodies _quant_kernel and _quant_kernel_int8), and computes
// what they compute:
//
//   per element of the scaled integer operand a' = (mh*2^26 + ml) * 2^e
//   (quant_residues/ref.py::decompose_int: mh signed, 0 <= ml < 2^26,
//   e >= 0) and per modulus p, in int32 only:
//     r = cmod(floor_mod(floor_mod(mh,p)*(2^26 mod p) + floor_mod(ml,p), p)
//              * (2^e mod p), p)
//   then the split of core/quantize.py: (hi, lo) by a round-half-even split
//   for a square modulus p = s^2 (hs zero-filled), (hi, lo, hi+lo) by a ceil
//   split for a Karatsuba modulus, each an e4m3 byte; or r itself as int8.
//   Outputs are the (N, m, k) stacks, modulus-major.
//
// The 2^e-mod-p tables (N x 1024 int32, 48 KiB at N = 12, 80 KiB at N = 20)
// sit in dynamic shared memory, loaded once per block; the index e is
// clamped to the table, as JAX's gather clamps. 2^26 mod p is the table's
// entry 26. One thread per element (grid-stride), all moduli in turn, so
// each frame is read once.
//
// Bound: bytes. 12 bytes of frame in and 3N (fp8) or N (int8) bytes out per
// element; the integer work is four runtime mods per modulus and element.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

constexpr int TABLE_LEN = 1024;  // moduli.POW2_TABLE_LEN
constexpr int MANT_SPLIT = 26;

template <bool INT8>
__global__ void __launch_bounds__(THREADS)
quant_residues_kernel(const int* __restrict__ mh, const int* __restrict__ ml,
                      const int* __restrict__ e, const int* __restrict__ tbl,
                      uint8_t* __restrict__ hi, uint8_t* __restrict__ lo,
                      uint8_t* __restrict__ hs, long long count,
                      const __grid_constant__ Moduli mod) {
  extern __shared__ int tbl_s[];  // [N][TABLE_LEN]
  __shared__ Moduli M;
  copy_moduli(M, mod);
  for (int i = threadIdx.x; i < mod.n * TABLE_LEN; i += THREADS) tbl_s[i] = tbl[i];
  __syncthreads();
  const int n_mod = M.n;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < count;
       i += stride) {
    const int vh = mh[i], vl = ml[i];
    const int ve = min(max(e[i], 0), TABLE_LEN - 1);
    for (int l = 0; l < n_mod; ++l) {
      const int p = M.ps[l];
      const int* pw = tbl_s + l * TABLE_LEN;
      const int rm = ozaki::floor_mod(vh, p) * pw[MANT_SPLIT] + ozaki::floor_mod(vl, p);
      const int r = ozaki::cmod(ozaki::floor_mod(rm, p) * pw[ve], p);
      const long long j = l * count + i;
      if constexpr (INT8) {
        hi[j] = static_cast<uint8_t>(static_cast<int8_t>(r));
      } else if (M.kind[l] == KIND_SQUARE) {
        const int s = M.split_s[l];
        const int h = ozaki::split_square_hi(r, s);
        hi[j] = ozaki::e4m3(h);
        lo[j] = ozaki::e4m3(r - s * h);
        hs[j] = 0;  // +0 in e4m3
      } else {
        const int h = ozaki::split_karatsuba_hi(r);
        const int w = r - 16 * h;
        hi[j] = ozaki::e4m3(h);
        lo[j] = ozaki::e4m3(w);
        hs[j] = ozaki::e4m3(h + w);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: the part stacks (N x count bytes each, count = m * k)
// from the int32 frame mh, ml, e (count each) and the 2^e-mod-p tables
// (N x 1024 int32): hi, lo, hs e4m3 for the fp8 families, or the int8 stack
// in hi with lo = hs = NULL for int8 (kind[] of every modulus KIND_INT8);
// all device pointers. The moduli constants are host arrays of num_moduli
// entries (inv: num_moduli x num_moduli, row-major). Returns the CUDA error
// of the launch (0 on success).
int quant_residues_launch(const int* mh, const int* ml, const int* e, const int* tbl,
                          uint8_t* hi, uint8_t* lo, uint8_t* hs, long long count,
                          int num_moduli, int device, const int* ps, const int* split_s,
                          const int* kind, const int* radix_order, const int* radix_ps,
                          const int* inv, const double* weights, void* stream) {
  if (num_moduli < 1 || num_moduli > MAXN || count <= 0 || !hi)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = kind[0] == KIND_INT8;
  if (int8 ? (lo || hs) : !(lo && hs)) return static_cast<int>(cudaErrorInvalidValue);
  const Moduli mod =
      make_moduli(num_moduli, ps, split_s, kind, radix_order, radix_ps, inv, weights);
  const size_t smem = static_cast<size_t>(num_moduli) * TABLE_LEN * sizeof(int);
  return on_device(device, [&]() {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long blocks = (count + THREADS - 1) / THREADS;
    const int grid = static_cast<int>(blocks < 4LL * sms ? blocks : 4LL * sms);
    auto s = static_cast<cudaStream_t>(stream);
    if (int8) {
      err = cudaFuncSetAttribute(quant_residues_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      quant_residues_kernel<true><<<grid, THREADS, smem, s>>>(mh, ml, e, tbl, hi, lo, hs, count,
                                                               mod);
    } else {
      err = cudaFuncSetAttribute(quant_residues_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      quant_residues_kernel<false><<<grid, THREADS, smem, s>>>(mh, ml, e, tbl, hi, lo, hs,
                                                                count, mod);
    }
    return cudaGetLastError();
  });
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
