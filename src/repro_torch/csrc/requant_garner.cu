// The requant + Garner pass of the phase-split Ozaki-II pipeline, for Hopper
// (sm_90a). Replaces repro/kernels/crt_reconstruct/kernel.py::requant_garner
// (bodies _kernel_fp8 and _kernel_int8, with the helpers _centered, _cmod,
// _combine and _garner), and computes what they compute:
//
//   per output element and modulus l, the residue products of the GEMM
//   schedule (c1, c2, c3 f32 planes of the fp8 families, exact integers
//   |c| <= 2^24; or one int32 plane for int8) -> the centred residue of A'B'
//   mod p_l (eq. (12) for a square modulus, eq. (9) for a Karatsuba
//   modulus, cmod for int8) -> balanced Garner mixed-radix digits in radix
//   order,
//
// and then, in one of two modes:
//   - digits: the int16 digit planes (N, m, n), the TPU kernel's own output;
//   - f64: the reference's epilogue (crt_reconstruct/ops.py::
//     reconstruct_f64, which the TPU leaves to XLA only for want of f64):
//     the Kahan sum of the digits under the radix weights and
//     ldexp_wide(v, -(lmu_i + lnu_j)), C (m, n) f64. That is K1/K2's
//     finalize (fused_common.cuh), the same sequence bit for bit.
//
// Bound: bytes. Each element reads 3N f32 (N int32) and writes 8 bytes (f64
// mode) or 2N (digits); its N(N-1)/2 Garner steps and N combines take about
// as long on the card (tools/kernel_variants.py), so the design cuts the
// arithmetic to what the card runs at its f32 rate: the combine reduces each
// product by mod_near and the sum by cmod_exact (ozaki_int.cuh: f32 FMAs,
// no division and no int/float conversion; for int8, c = hi * 2^15 + lo with
// both halves exact in f32), the Garner steps are garner's (the same way),
// and the Kahan sum is finalize's; every digit sits in a register (loops
// unrolled to NMAX, guarded on N) and the Garner constants are operands
// read from the kernel parameter. Each thread owns 2 consecutive elements,
// loaded as one 8-byte word per plane, the planes of B moduli at a time (a
// scalar path takes ragged tails and planes that are not 8-byte aligned):
// few enough registers for 3-4 blocks of 128 threads an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

constexpr int E = 2;          // consecutive elements per thread
constexpr int B = 4;          // moduli whose product planes are loaded together
constexpr int K5_THREADS = 128;
// The kernel is compiled for N <= 14 (every family's default) and for
// N <= MAXN: the registers of the digits a thread holds follow NMAX.
constexpr int NMAX_SMALL = 14;

// E values of one plane at o: one 8-byte load where the plane is aligned
// and the group lies inside it, else guarded scalar loads (0 past count).
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ src, long long o, bool vec,
                                           long long left, T (&x)[E]) {
  static_assert(sizeof(T) == 4 && E == 2, "two 32-bit values");
  if (vec) {
    const uint2 w = __ldcs(reinterpret_cast<const uint2*>(src + o));
    x[0] = *reinterpret_cast<const T*>(&w.x);
    x[1] = *reinterpret_cast<const T*>(&w.y);
  } else {
#pragma unroll
    for (int u = 0; u < E; ++u) x[u] = u < left ? src[o + u] : T(0);
  }
}

// Centred residue of one modulus' product (crt.combine_residue_product).
// fp8: each product is first brought to |c'| <= p/2 + 1 by mod_near (|c| <=
// 2^24), so s*(c1' + c2') + c3' (square, s <= 33) and 256 c1' + c2' +
// 16 (c3' - c1' - c2') (Karatsuba, p <= 513) are exact f32 integers below
// 2^17, congruent to the reference's sums; cmod_exact then gives the one
// centred residue. int8: c = hi * 2^15 + lo (|hi| <= 2^16, 0 <= lo < 2^15)
// and hi' = mod_near(hi), so hi' * (2^15 mod p) + lo < 2^16. M holds the
// modulus' p, RN(1/p) and floor((p-1)/2) at its radix position d.
template <bool INT8>
__device__ __forceinline__ int combine(const float (&c)[3], int ci, bool square, int s,
                                       const Moduli& M, int d, float w15) {
  const float p = M.rp[d], ip = M.rip[d];
  float v;
  if constexpr (INT8) {
    const float hi = ozaki::mod_near(ozaki::small_to_float(ci >> 15), p, ip);
    v = __fmaf_rn(hi, w15, ozaki::small_to_float(ci & 0x7FFF));
  } else {
    const float c1 = ozaki::mod_near(c[0], p, ip), c2 = ozaki::mod_near(c[1], p, ip),
                c3 = ozaki::mod_near(c[2], p, ip);
    if (square) {
      v = __fmaf_rn(static_cast<float>(s), __fadd_rn(c1, c2), c3);
    } else {
      const float t = __fsub_rn(__fsub_rn(c3, c1), c2);
      v = __fmaf_rn(16.f, t, __fmaf_rn(256.f, c1, c2));
    }
  }
  return ozaki::small_to_int(ozaki::cmod_exact(v, p, ip, M.rhalf[d]));
}

template <bool INT8, bool F64, int NMAX>
__global__ void __launch_bounds__(K5_THREADS)
requant_garner_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
                      const float* __restrict__ c3, const int* __restrict__ ci,
                      const int* __restrict__ lmu, const int* __restrict__ lnu,
                      int16_t* __restrict__ digits_out, double* __restrict__ out,
                      long long count, int ncols, bool aligned,
                      const __grid_constant__ Moduli mod) {
  __shared__ Moduli M;
  __shared__ float w15[MAXN];  // 2^15 mod radix_ps[d] (int8's combine)
  copy_moduli(M, mod);
  if (threadIdx.x < mod.n)
    w15[threadIdx.x] = static_cast<float>((1 << 15) % mod.radix_ps[threadIdx.x]);
  __syncthreads();
  const int n_mod = M.n;
  const long long groups = (count + E - 1) / E;
  const long long stride = static_cast<long long>(gridDim.x) * K5_THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * K5_THREADS + threadIdx.x; g < groups;
       g += stride) {
    const long long i0 = g * E, left = count - i0;
    const bool vec = aligned && left >= E;
    // the residues in radix order, B moduli's loads in flight at a time
    int t[E][MAXN];
#pragma unroll
    for (int d0 = 0; d0 < NMAX; d0 += B) {
      if (d0 < n_mod) {
        float x[B][3][E];
        int xi[B][E];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          if (d0 + b < NMAX && d0 + b < n_mod) {
            const long long o = M.radix_order[d0 + b] * count + i0;
            if constexpr (INT8) {
              load_group(ci, o, vec, left, xi[b]);
            } else {
              load_group(c1, o, vec, left, x[b][0]);
              load_group(c2, o, vec, left, x[b][1]);
              load_group(c3, o, vec, left, x[b][2]);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int d = d0 + b;
          if (d < NMAX && d < n_mod) {
            const int l = M.radix_order[d];
            const bool square = M.kind[l] == KIND_SQUARE;
            const int s = M.split_s[l];
#pragma unroll
            for (int u = 0; u < E; ++u) {
              if constexpr (INT8) {
                t[u][d] = combine<true>({0.f, 0.f, 0.f}, xi[b][u], false, 0, mod, d, w15[d]);
              } else {
                t[u][d] = combine<false>({x[b][0][u], x[b][1][u], x[b][2][u]}, 0, square, s,
                                         mod, d, 0.f);
              }
            }
          }
        }
      }
    }
    if constexpr (F64) {
      // the row and column of each element, from the group's first
      int e[E];
      long long row = i0 / ncols;
      int col = static_cast<int>(i0 - row * ncols);
#pragma unroll
      for (int u = 0; u < E; ++u) {
        e[u] = u < left ? -(lmu[row] + lnu[col]) : 0;
        if (++col == ncols) col = 0, ++row;
      }
      double v[E];
      finalize<E, NMAX>(mod, t, e, v);  // the parameter: constants as operands
      if (vec) {
        __stcs(reinterpret_cast<double2*>(out + i0), make_double2(v[0], v[1]));
      } else {
#pragma unroll
        for (int u = 0; u < E; ++u)
          if (u < left) out[i0 + u] = v[u];
      }
    } else {
      float dg[E][MAXN];
      garner<E, NMAX>(mod, t, dg);
#pragma unroll
      for (int d = 0; d < NMAX; ++d) {
        if (d < n_mod) {
          int16_t* dst = digits_out + d * count + i0;
          int x[E];
#pragma unroll
          for (int u = 0; u < E; ++u) x[u] = ozaki::small_to_int(dg[u][d]);
          if (vec) {
            *reinterpret_cast<uint32_t*>(dst) =
                (x[0] & 0xFFFF) | (static_cast<uint32_t>(x[1]) << 16);
          } else {
#pragma unroll
            for (int u = 0; u < E; ++u)
              if (u < left) dst[u] = static_cast<int16_t>(x[u]);
          }
        }
      }
    }
  }
}

template <bool INT8, bool F64, int NMAX>
cudaError_t launch_n(const float* c1, const float* c2, const float* c3, const int* ci,
                     const int* lmu, const int* lnu, int16_t* digits, double* out,
                     long long count, int ncols, bool aligned, const Moduli& mod, int sms,
                     cudaStream_t s) {
  auto kernel = requant_garner_kernel<INT8, F64, NMAX>;
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K5_THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long blocks = (count + K5_THREADS * E - 1) / (K5_THREADS * E);
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(blocks < resident ? blocks : resident);
  kernel<<<grid, K5_THREADS, 0, s>>>(c1, c2, c3, ci, lmu, lnu, digits, out, count, ncols,
                                     aligned, mod);
  return cudaGetLastError();
}

template <bool INT8, bool F64>
cudaError_t launch(const float* c1, const float* c2, const float* c3, const int* ci,
                   const int* lmu, const int* lnu, int16_t* digits, double* out,
                   long long count, int ncols, bool aligned, const Moduli& mod, int sms,
                   cudaStream_t s) {
  return mod.n <= NMAX_SMALL
             ? launch_n<INT8, F64, NMAX_SMALL>(c1, c2, c3, ci, lmu, lnu, digits, out, count,
                                               ncols, aligned, mod, sms, s)
             : launch_n<INT8, F64, MAXN>(c1, c2, c3, ci, lmu, lnu, digits, out, count, ncols,
                                         aligned, mod, sms, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

}  // namespace

extern "C" {

// Launch on `stream`, from the product planes, each (N x count) with count
// = m * n: c1, c2, c3 f32 for the fp8 families (ci = NULL), or ci int32 for
// int8 (c1 = c2 = c3 = NULL). Digits mode (out = NULL, lmu = lnu = NULL):
// the int16 digit stack (N x count, radix order) into `digits`. f64 mode
// (digits = NULL): C = the Kahan sum of the digits, ldexp_wide'd by
// -(lmu[i] + lnu[j]), into out (m x n f64), with lmu (m) and lnu (n = ncols)
// int32. All device pointers. The moduli constants are host arrays of
// num_moduli entries (inv: num_moduli x num_moduli, row-major). Returns the
// CUDA error of the launch (0 on success).
int requant_garner_launch(const float* c1, const float* c2, const float* c3, const int* ci,
                          const int* lmu, const int* lnu, int16_t* digits, double* out,
                          long long count, int ncols, int num_moduli, int device,
                          const int* ps, const int* split_s, const int* kind,
                          const int* radix_order, const int* radix_ps, const int* inv,
                          const double* weights, void* stream) {
  const bool int8 = ci != nullptr;
  const bool f64 = out != nullptr;
  if (num_moduli < 1 || num_moduli > MAXN || count <= 0 || ncols <= 0 ||
      (int8 ? (c1 || c2 || c3) : !(c1 && c2 && c3)) ||
      (f64 ? (digits || !lmu || !lnu) : (!digits || lmu || lnu)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Moduli mod =
      make_moduli(num_moduli, ps, split_s, kind, radix_order, radix_ps, inv, weights);
  const bool aligned = count % E == 0 &&
                       (int8 ? aligned8(ci) : aligned8(c1) && aligned8(c2) && aligned8(c3)) &&
                       (f64 ? aligned16(out) : (reinterpret_cast<uintptr_t>(digits) & 3) == 0);
  return on_device(device, [&]() {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    auto s = static_cast<cudaStream_t>(stream);
    if (int8) {
      return f64 ? launch<true, true>(c1, c2, c3, ci, lmu, lnu, digits, out, count, ncols,
                                      aligned, mod, sms, s)
                 : launch<true, false>(c1, c2, c3, ci, lmu, lnu, digits, out, count, ncols,
                                       aligned, mod, sms, s);
    }
    return f64 ? launch<false, true>(c1, c2, c3, ci, lmu, lnu, digits, out, count, ncols,
                                     aligned, mod, sms, s)
               : launch<false, false>(c1, c2, c3, ci, lmu, lnu, digits, out, count, ncols,
                                      aligned, mod, sms, s);
  });
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
