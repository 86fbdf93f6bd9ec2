// Integer and f64 helpers of the Ozaki-II quantization and reconstruction,
// shared by the CUDA kernels of repro_torch.
//
// Device counterparts of repro/kernels/crt_reconstruct/kernel.py (_centered,
// _cmod, _combine, lines 24-44; the Garner steps are fused_common.cuh's),
// of the residue splits of repro/core/quantize.py (split_square,
// split_karatsuba) and of numerics.ldexp_wide. They must give the
// reference's integers bit for bit: C's % truncates toward zero while
// jnp.mod and torch.remainder floor, so every integer reduction goes through
// floor_mod, and the f32 reductions (mod_near, cmod_exact) give the same
// centred residues.
#pragma once

#include <cuda_fp8.h>

#include <cstdint>

namespace ozaki {

// x mod p in [0, p) for p > 0 (floor semantics).
__device__ __forceinline__ int floor_mod(int x, int p) {
  int r = x % p;
  return r < 0 ? r + p : r;
}

// Centred representative of r in [0, p): odd p -> [-(p-1)/2, (p-1)/2],
// even p -> [-p/2, p/2-1].
__device__ __forceinline__ int centered(int r, int p) {
  return r > (p - 1) / 2 ? r - p : r;
}

__device__ __forceinline__ int cmod(int x, int p) { return centered(floor_mod(x, p), p); }

// Centred residue of one modulus' product from its partial products:
// eq. (12) for a square modulus p = s^2 (c1 = A1B2, c2 = A2B1, c3 = A2B2),
// eq. (9) for a Karatsuba modulus (c1 = A1B1, c2 = A2B2, c3 = (A1+A2)(B1+B2)),
// the big terms reduced first so every intermediate stays below 2^31.
__device__ __forceinline__ int combine(int c1, int c2, int c3, int p, bool square, int s) {
  if (square) return cmod(s * (c1 + c2) + c3, p);
  return cmod(256 * cmod(c1, p) + cmod(c2, p) + 16 * cmod(c3 - c1 - c2, p), p);
}

// hi of the round split of a residue of a square modulus p = s^2
// (quantize.split_square): round(r / s) half to even, after an IEEE f32
// division, as jnp.round(r.astype(f32) / f32(s)) computes it. lo = r - s*hi.
__device__ __forceinline__ int split_square_hi(int r, int s) {
  return __float2int_rn(__fdiv_rn(static_cast<float>(r), static_cast<float>(s)));
}

// hi of the ceil split of a residue of a Karatsuba modulus
// (quantize.split_karatsuba): sign(r) * ceil(|r| / 16). lo = r - 16*hi,
// hs = hi + lo.
__device__ __forceinline__ int split_karatsuba_hi(int r) {
  return ((r > 0) - (r < 0)) * ((abs(r) + 15) / 16);
}

// A small integer (|v| <= 16 for the parts, exact in e4m3) as its e4m3 byte.
__device__ __forceinline__ uint8_t e4m3(int v) {
  return static_cast<uint8_t>(
      __nv_cvt_float_to_fp8(static_cast<float>(v), __NV_SATFINITE, __NV_E4M3));
}

// -- the same reductions on integer-valued f32, without a division or a
// conversion instruction (the card converts between int and float several
// times slower than it issues f32 FMAs) --------------------------------------

// 1.5 * 2^23: for |y| < 2^22, y + RND is rounded to an integer, and for an
// integer y the bits of y + RND are RND_BITS + y.
constexpr float RND = 12582912.0f;
constexpr int RND_BITS = 0x4B400000;

// Integer |x| < 2^22 as float, and back.
__device__ __forceinline__ float small_to_float(int x) {
  return __fsub_rn(__int_as_float(RND_BITS + x), RND);
}
__device__ __forceinline__ int small_to_int(float x) {
  return __float_as_int(__fadd_rn(x, RND)) - RND_BITS;
}

// A representative of x mod p of magnitude <= p/2 + 1, for integer-valued
// |x| <= 2^24 and 4 <= p < 2^11, ip = RN(1/p). q = rint(x * ip) by the RND
// rounding (|x * ip| < 2^22), and |x * ip - x / p| <= |x| 2^-24 / p <= 1/p,
// so |x - q p| <= p/2 + 1; the FMA gives that integer exactly.
__device__ __forceinline__ float mod_near(float x, float p, float ip) {
  const float q = __fsub_rn(__fmaf_rn(x, ip, RND), RND);
  return __fmaf_rn(-q, p, x);
}

// The centred residue cmod(x, p) (odd p: [-(p-1)/2, (p-1)/2], even p:
// [-p/2, p/2-1]) of integer-valued |x| < 2^23, half = floor((p-1)/2). Unless
// x/p is a half-integer its distance to one is >= 1/(2p), more than
// |x * ip - x/p| <= |x| 2^-24 / p, so q = rint(x / p) and |x - q p| <= p/2;
// a half-integer (even p only) leaves +-p/2, and +p/2 moves to -p/2.
__device__ __forceinline__ float cmod_exact(float x, float p, float ip, float half) {
  const float r = mod_near(x, p, ip);
  return r > half ? __fsub_rn(r, p) : r;
}

// floor(e / 2): ldexp_wide's split is a floor division, C's / truncates.
__device__ __forceinline__ int floor_half(int e) { return e >= 0 ? e / 2 : -((1 - e) / 2); }

// 2^e as float64 from its bit pattern: exact wherever representable, 0 below
// 2^-1074, inf above 2^1023 (numerics.pow2 of the plain version).
__device__ __forceinline__ double pow2(int e) {
  if (e > 1023) return __longlong_as_double(0x7FF0000000000000LL);
  if (e >= -1022) return __longlong_as_double(static_cast<long long>(e + 1023) << 52);
  if (e >= -1074) return __longlong_as_double(1LL << (e + 1074));
  return 0.0;
}

// x * 2^e in two exact halves (numerics.ldexp_wide).
__device__ __forceinline__ double ldexp_wide(double x, int e) {
  int e1 = floor_half(e);
  return __dmul_rn(__dmul_rn(x, pow2(e1)), pow2(e - e1));
}

}  // namespace ozaki
