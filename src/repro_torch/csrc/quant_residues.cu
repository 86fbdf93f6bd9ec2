// The residue quantization pass of the phase-split Ozaki-II pipeline, for
// Hopper (sm_90a). Replaces repro/kernels/quant_residues/kernel.py::
// quant_residues (bodies _quant_kernel and _quant_kernel_int8), and computes
// what they compute:
//
//   per element of the scaled integer operand a' = mant * 2^e and per
//   modulus p, the centred residue r of a' mod p, then the split of
//   core/quantize.py: (hi, lo) by a round-half-even split for a square
//   modulus p = s^2 (hs zero-filled), (hi, lo, hi+lo) by a ceil split for a
//   Karatsuba modulus, each an e4m3 byte; or r itself as int8. Outputs are
//   the (N, m, k) stacks, modulus-major.
//
// Two entries, one kernel:
//   - frame: the int32 frame (mh, ml, e) of quant_residues/ref.py::
//     decompose_int, mant = mh * 2^26 + ml, the TPU kernel's own input;
//   - f64: the f64 operand and its per-row (or per-column) log2 scales,
//     a' = trunc(ldexp_wide(a, lscale)) (quantize.scaled_int) taken apart
//     into mant and e as numerics.f64_to_mant_exp does, from its bits in
//     registers. The TPU kernel takes the frame only because its VPU has no
//     f64; here the two PyTorch passes that made it (12 bytes an element
//     written and read back) go.
//
// Bound: bytes, 8 (f64) or 12 (frame) in and 3N (fp8) or N (int8) out an
// element. On the card the residue work takes about as long as that traffic
// (for int8, with a third of the bytes, longer; tools/kernel_variants.py),
// so it is kept to the card's f32 rate:
//   - mant is cut into 11-bit limbs a_j (exact in f32), and
//     r = cmod_exact(mod_near(sum_j a_j (2^11j mod p)) * (2^e mod p)), all
//     f32 FMAs on exact integers below 2^24 (ozaki_int.cuh: no division, no
//     int/float conversion). The 2^e-mod-p tables (N x 1024, as f32) sit in
//     shared memory; the index e is clamped to the table, as JAX's gather
//     clamps.
//   - the split and the e4m3 encoding are one shared-memory lookup: a table
//     per modulus from the centred residue to its packed part bytes,
//     (N x 1089) words, made at block start by the exact device helpers
//     (int8 needs none: its part is the residue's byte).
//     The round split is round-half-even of r/s with |r| <= 544 and s <= 33:
//     the IEEE f32 quotient of the reference (jnp.round(f32(r) / f32(s)))
//     is within 544 * 2^-24 / s of r/s, while an r/s that is not a
//     half-integer lies at least 1/(2s) from one, so the f32 quotient never
//     rounds onto a half and the table is exact.
//   - each thread owns 2 groups of 4 consecutive elements: one or two
//     16-byte loads per group, and one 4-byte store per group and part plane
//     (a warp writes 128 contiguous bytes of each plane); a scalar path takes
//     ragged tails and planes that are not 16-byte aligned.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

constexpr int TABLE_LEN = 1024;  // moduli.POW2_TABLE_LEN
constexpr int SPLIT_LEN = 1089;  // the largest modulus: residues -544..544
constexpr int MANT_SPLIT = 26;
constexpr int E = 4;       // consecutive elements of a group
constexpr int G = 2;       // groups per thread
constexpr int LIMB = 11;   // limb bits: 6 limbs x (2^11 - 1) x 1088 < 2^24

// Per-modulus f32 constants: p, RN(1/p), floor((p-1)/2), RND + floor(p/2)
// (the split table's index of r is the bits of r + rnd_off less RND_BITS),
// and 2^(11 j) mod p.
struct QConst {
  float p, ip, half, rnd_off;
  float c[6];
};

// The element's limbs (signed, the sign of mant on each) and its exponent.
template <int NL>
struct Elem {
  float a[NL];
  int e;
};

template <int NL>
__device__ __forceinline__ void set_limbs(Elem<NL>& x, unsigned long long mag, bool neg, int e) {
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const float a = ozaki::small_to_float(static_cast<int>((mag >> (LIMB * j)) & 0x7FF));
    x.a[j] = neg ? -a : a;
  }
  x.e = min(max(e, 0), TABLE_LEN - 1);
}

// The frame (mh, ml, e): mant = mh * 2^26 + ml, |mant| < 2^58 (6 limbs).
__device__ __forceinline__ void from_frame(Elem<6>& x, int mh, int ml, int e) {
  const long long mant = static_cast<long long>(mh) * (1LL << MANT_SPLIT) + ml;
  set_limbs(x, static_cast<unsigned long long>(mant < 0 ? -mant : mant), mant < 0, e);
}

// a' = trunc(ldexp_wide(a, ls)) as mant * 2^e (f64_to_mant_exp): below 2^53
// in magnitude mant = a' and e = 0; above, mant is the 53-bit significand
// and e = exponent - 52. From the bits of y = ldexp_wide(a, ls) (the same
// two multiplies as the plain version): its significand shifted right by
// 52 - exponent is trunc(|y|); |y| < 1 gives 0. |mant| < 2^53 (5 limbs).
__device__ __forceinline__ void from_f64(Elem<5>& x, double a, int ls) {
  const long long bits = __double_as_longlong(ozaki::ldexp_wide(a, ls));
  const int ue = static_cast<int>((bits >> 52) & 0x7FF) - 1023;
  const unsigned long long sig = (bits & ((1LL << 52) - 1)) | (1LL << 52);
  unsigned long long mag = 0;
  int e = 0;
  if (ue >= 0) {
    mag = ue <= 52 ? sig >> (52 - ue) : sig;
    e = ue <= 52 ? 0 : ue - 52;
  }
  set_limbs(x, mag, bits < 0, e);
}

// The centred residue of one element under modulus k, an exact f32 integer.
template <int NL>
__device__ __forceinline__ float residue(const Elem<NL>& x, const QConst& k, const float* pw) {
  float t = __fmul_rn(x.a[0], k.c[0]);
#pragma unroll
  for (int j = 1; j < NL; ++j) t = __fmaf_rn(x.a[j], k.c[j], t);
  t = ozaki::mod_near(t, k.p, k.ip);                                      // |t| <= p/2 + 1
  return ozaki::cmod_exact(__fmul_rn(t, pw[x.e]), k.p, k.ip, k.half);  // |t w| < 2^20
}

// The packed part bytes of a centred residue: the split table's entry at
// r + floor(p/2), or for int8 the residue's own byte.
template <bool INT8>
__device__ __forceinline__ uint32_t part_word(float r, const QConst& k, const uint32_t* split) {
  if constexpr (INT8) {
    return static_cast<uint8_t>(ozaki::small_to_int(r));
  } else {
    return split[__float_as_int(__fadd_rn(r, k.rnd_off)) - ozaki::RND_BITS];
  }
}

// Four elements' packed part words (byte q of w[u]: part q of element u)
// as the word of part plane q, element u in byte u.
__device__ __forceinline__ uint32_t plane_word(const uint32_t (&w)[E], int q) {
  const uint32_t sel = 0x40 + 0x11 * q;  // bytes 0, 1 <- byte q of x, of y
  return __byte_perm(__byte_perm(w[0], w[1], sel), __byte_perm(w[2], w[3], sel), 0x5410);
}

template <bool INT8, bool F64>
__global__ void __launch_bounds__(THREADS)
quant_residues_kernel(const int* __restrict__ mh, const int* __restrict__ ml,
                      const int* __restrict__ ex, const double* __restrict__ a,
                      const int* __restrict__ lscale, const int* __restrict__ tbl,
                      uint8_t* __restrict__ hi, uint8_t* __restrict__ lo,
                      uint8_t* __restrict__ hs, long long count, int ncols, int axis,
                      bool aligned, const __grid_constant__ Moduli mod) {
  constexpr int NL = F64 ? 5 : 6;
  constexpr int NP = INT8 ? 1 : 3;
  extern __shared__ float smem[];
  float* pw_s = smem;                                                   // [N][TABLE_LEN]
  uint32_t* split_s = reinterpret_cast<uint32_t*>(smem + mod.n * TABLE_LEN);  // [N][SPLIT_LEN]
  __shared__ QConst K[MAXN];
  const int n_mod = mod.n;
  for (int i = threadIdx.x; i < n_mod * TABLE_LEN; i += THREADS)
    pw_s[i] = static_cast<float>(tbl[i]);
  for (int i = threadIdx.x; i < (INT8 ? 0 : n_mod * SPLIT_LEN); i += THREADS) {
    const int l = i / SPLIT_LEN, p = mod.ps[l], r = i % SPLIT_LEN - p / 2;
    uint32_t w = 0;
    if (r < p - p / 2) {
      if (mod.kind[l] == KIND_SQUARE) {
        const int s = mod.split_s[l], h = ozaki::split_square_hi(r, s);
        w = ozaki::e4m3(h) | static_cast<uint32_t>(ozaki::e4m3(r - s * h)) << 8;
      } else {
        const int h = ozaki::split_karatsuba_hi(r), v = r - 16 * h;
        w = ozaki::e4m3(h) | static_cast<uint32_t>(ozaki::e4m3(v)) << 8 |
            static_cast<uint32_t>(ozaki::e4m3(h + v)) << 16;
      }
    }
    split_s[i] = w;
  }
  if (threadIdx.x < n_mod) {
    const int l = threadIdx.x, p = mod.ps[l];
    QConst k;
    k.p = static_cast<float>(p);
    k.ip = __frcp_rn(k.p);
    k.half = static_cast<float>((p - 1) / 2);
    k.rnd_off = ozaki::RND + static_cast<float>(p / 2);
    for (int j = 0; j < 6; ++j) k.c[j] = static_cast<float>(tbl[l * TABLE_LEN + LIMB * j]);
    K[l] = k;
  }
  __syncthreads();

  const long long groups = (count + E - 1) / E;
  uint8_t* const dst[3] = {hi, lo, hs};
  for (long long g0 = static_cast<long long>(blockIdx.x) * G * THREADS + threadIdx.x;
       g0 < groups; g0 += static_cast<long long>(gridDim.x) * G * THREADS) {
    Elem<NL> x[G][E];
    long long at[G];
    int left[G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const long long g = g0 + h * THREADS;
      const long long i0 = g * E;
      at[h] = i0;
      left[h] = g < groups ? static_cast<int>(min(count - i0, static_cast<long long>(E))) : 0;
      const bool vec = aligned && left[h] == E;
      if constexpr (F64) {
        double v[E];
        if (vec) {
          const double2 v01 = __ldcs(reinterpret_cast<const double2*>(a + i0));
          const double2 v23 = __ldcs(reinterpret_cast<const double2*>(a + i0) + 1);
          v[0] = v01.x, v[1] = v01.y, v[2] = v23.x, v[3] = v23.y;
        } else {
#pragma unroll
          for (int u = 0; u < E; ++u) v[u] = u < left[h] ? a[i0 + u] : 0.0;
        }
        long long row = i0 / ncols;
        int col = static_cast<int>(i0 - row * ncols);
#pragma unroll
        for (int u = 0; u < E; ++u) {
          const int ls = u < left[h] ? lscale[axis == 0 ? row : col] : 0;
          from_f64(x[h][u], v[u], ls);
          if (++col == ncols) col = 0, ++row;
        }
      } else {
        int vh[E], vl[E], ve[E];
        if (vec) {
          const int4 wh = __ldcs(reinterpret_cast<const int4*>(mh + i0));
          const int4 wl = __ldcs(reinterpret_cast<const int4*>(ml + i0));
          const int4 we = __ldcs(reinterpret_cast<const int4*>(ex + i0));
          vh[0] = wh.x, vh[1] = wh.y, vh[2] = wh.z, vh[3] = wh.w;
          vl[0] = wl.x, vl[1] = wl.y, vl[2] = wl.z, vl[3] = wl.w;
          ve[0] = we.x, ve[1] = we.y, ve[2] = we.z, ve[3] = we.w;
        } else {
#pragma unroll
          for (int u = 0; u < E; ++u) {
            const bool in = u < left[h];
            vh[u] = in ? mh[i0 + u] : 0;
            vl[u] = in ? ml[i0 + u] : 0;
            ve[u] = in ? ex[i0 + u] : 0;
          }
        }
#pragma unroll
        for (int u = 0; u < E; ++u) from_frame(x[h][u], vh[u], vl[u], ve[u]);
      }
    }
    for (int l = 0; l < n_mod; ++l) {
      const QConst k = K[l];
      const float* pw = pw_s + l * TABLE_LEN;
      const uint32_t* split = split_s + l * SPLIT_LEN;
      const long long plane = l * count;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (left[h] == 0) continue;
        uint32_t w[E];
#pragma unroll
        for (int u = 0; u < E; ++u) w[u] = part_word<INT8>(residue(x[h][u], k, pw), k, split);
        if (aligned && left[h] == E) {
#pragma unroll
          for (int q = 0; q < NP; ++q)
            __stcs(reinterpret_cast<unsigned int*>(dst[q] + plane + at[h]), plane_word(w, q));
        } else {
#pragma unroll
          for (int q = 0; q < NP; ++q) {
#pragma unroll
            for (int u = 0; u < E; ++u)
              if (u < left[h]) dst[q][plane + at[h] + u] = static_cast<uint8_t>(w[u] >> (8 * q));
          }
        }
      }
    }
  }
}

template <bool INT8, bool F64>
cudaError_t launch(const int* mh, const int* ml, const int* e, const double* a,
                   const int* lscale, const int* tbl, uint8_t* hi, uint8_t* lo, uint8_t* hs,
                   long long count, int ncols, int axis, bool aligned, const Moduli& mod,
                   int sms, cudaStream_t s) {
  auto kernel = quant_residues_kernel<INT8, F64>;
  const size_t smem = static_cast<size_t>(mod.n) * (TABLE_LEN + (INT8 ? 0 : SPLIT_LEN)) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (count + THREADS * G * E - 1) / (THREADS * G * E);
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(blocks < resident ? blocks : resident);
  kernel<<<grid, THREADS, smem, s>>>(mh, ml, e, a, lscale, tbl, hi, lo, hs, count, ncols, axis,
                                     aligned, mod);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Launch on `stream`: the part stacks (N x count bytes each, count = m * k,
// ncols = k) from either the int32 frame mh, ml, e (count each; a = lscale
// = NULL) or the f64 operand a (m x k, row-major) with its log2 scales
// lscale, per row (axis 0, m entries) or per column (axis 1, k entries)
// (mh = ml = e = NULL); and the 2^e-mod-p tables (N x 1024 int32): hi, lo,
// hs e4m3 for the fp8 families, or the int8 stack in hi with lo = hs = NULL
// for int8 (kind[] of every modulus KIND_INT8); all device pointers. The
// moduli constants are host arrays of num_moduli entries (inv: num_moduli x
// num_moduli, row-major). Returns the CUDA error of the launch (0 on
// success).
int quant_residues_launch(const int* mh, const int* ml, const int* e, const double* a,
                          const int* lscale, const int* tbl, uint8_t* hi, uint8_t* lo,
                          uint8_t* hs, long long count, int ncols, int axis, int num_moduli,
                          int device, const int* ps, const int* split_s, const int* kind,
                          const int* radix_order, const int* radix_ps, const int* inv,
                          const double* weights, void* stream) {
  if (num_moduli < 1 || num_moduli > MAXN || count <= 0 || ncols <= 0 || !hi || !tbl ||
      (axis != 0 && axis != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < num_moduli; ++l)
    if (ps[l] < 4 || ps[l] > SPLIT_LEN) return static_cast<int>(cudaErrorInvalidValue);
  const bool f64 = a != nullptr;
  if (f64 ? (mh || ml || e || !lscale) : (!mh || !ml || !e || lscale))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = kind[0] == KIND_INT8;
  if (int8 ? (lo || hs) : !(lo && hs)) return static_cast<int>(cudaErrorInvalidValue);
  const Moduli mod =
      make_moduli(num_moduli, ps, split_s, kind, radix_order, radix_ps, inv, weights);
  const bool aligned = count % E == 0 && aligned16(hi) &&
                       (int8 || (aligned16(lo) && aligned16(hs))) &&
                       (f64 ? aligned16(a) : aligned16(mh) && aligned16(ml) && aligned16(e));
  return on_device(device, [&]() {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    auto s = static_cast<cudaStream_t>(stream);
    if (int8) {
      return f64 ? launch<true, true>(mh, ml, e, a, lscale, tbl, hi, lo, hs, count, ncols, axis,
                                      aligned, mod, sms, s)
                 : launch<true, false>(mh, ml, e, a, lscale, tbl, hi, lo, hs, count, ncols,
                                       axis, aligned, mod, sms, s);
    }
    return f64 ? launch<false, true>(mh, ml, e, a, lscale, tbl, hi, lo, hs, count, ncols, axis,
                                     aligned, mod, sms, s)
               : launch<false, false>(mh, ml, e, a, lscale, tbl, hi, lo, hs, count, ncols, axis,
                                      aligned, mod, sms, s);
  });
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
