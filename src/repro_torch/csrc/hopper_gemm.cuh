// The GEMM core of both fused Ozaki-II kernels (K1 = fused_raw.cu after its
// residue prologue, K2 = fused_parts.cu after its B transpose), for Hopper
// (sm_90a): from K-major residue parts to the f64 product.
//
//   A parts: (hi, lo, hs) e4m3 stacks (N, m, k), or one int8 stack;
//   B parts: the same, K-MAJOR (N, n, k): wgmma takes 8-bit operands only
//            K-major (its transpose flag exists for 16-bit types only);
//   per modulus l, the eq. (12) products (A1B2, A2B1, A2B2) of a square
//   modulus, the eq. (8) products (A1B1, A2B2, (A1+A2)(B1+B2)) of a
//   Karatsuba modulus, or the single int8 product -> combine -> centred
//   residue (int16, into a scratch (N, m, n)); after the last modulus,
//   finalize (fused_common.cuh: Garner digits, Kahan f64 sum, ldexp_wide),
//   or, given no C (the reference's reconstruct="xla"), the Garner digits
//   alone, int16 in radix order, written over the scratch.
//   A square modulus never reads an hs part.
//
// Schedule. A cluster of two blocks per 128 x 128 output tile, each block
// a BM x BN = 128 x 64 half; the clusters in groups of GROUP_M row tiles, so
// that the blocks resident at once share their panels in L2. Warpgroup 2 of
// each block is the producer: one thread issues the TMA loads of every
// (modulus, 128-deep k-tile) into a ring of SLOTS shared-memory slots
// (128-byte swizzle, full/empty mbarriers), one slot per part of A and of B:
// a k-tile takes 2 consecutive slots for a square modulus, 3 for a Karatsuba
// one, 1 for int8, so 3 to 9 k-tiles are in flight. The two blocks share
// their A tile: each loads one 64-row half and multicasts it into both, so
// L2 carries 3N * mnk * (1/128 + 1/128) bytes, as for a 128 x 128 tile,
// and a slot is refilled once the consumers of both blocks have released it.
// Warps 0-7 are two consumer warpgroups, each a 64 x 64 quarter of the
// cluster's tile: per k32 step one wgmma m64n64k32 per product, both
// operands from shared memory. The moduli run in the OUTER loop, as the
// per-modulus accumulators of a block's tile (3 x 128 x 64 f32) already take
// most of the register file.
//
// Exactness by promotion. FP8: each k32 step's product is issued into a
// FRESH f32 fragment (scale-d = 0) and added on the CUDA cores into a
// per-product f32 accumulator: the promotion interval is KC = 1 k32 step,
// so a chain in the tensor core's accumulator sums at most 32 * 16 * 16 =
// 2^13. Hopper's FP8 wgmma accumulation keeps fewer bits than f32 (the
// DeepSeek-V3 report, arXiv:2412.19437): fused_raw.cu's wgmma probe found a
// chained accumulator leaving the exact sum after 16 k32 steps, once a
// running sum of 2^17 meets small products. The f32 accumulator stays exact
// while |sum| <= k * 2^8 <= 2^24, so a contraction past CHUNK = 2^16 runs
// in chunks (the kernel's LONG instantiation): at each chunk's end the
// chunk's accumulators are combined into a centred residue, which is added
// mod p to the running residue in the scratch plane (the first chunk writes
// it), and the accumulators start again from 0. The combine is linear mod
// p, so the residue is the exact one at any k; each chunk's combine sees
// what the whole k did at k <= 2^16 (square: |s*(c1 + c2) + c3| <= 67 *
// 2^24 < 2^31), and the running residue lives in memory, not in registers
// (a consumer thread has no registers to spare, below). The reference's int32 accumulators
// hold the fp8 families to k <= 2^21 (kernels/fused/kernel.py::max_k).
// int8: the s8 wgmma accumulates in s32 (|sum| <= k * 2^14 < 2^31 for
// k <= 2^16, the int8 family's limit), with no promotion.
//
// Registers. A consumer thread holds 3 x 32 accumulators and 3 x 32 fresh
// fragments. The block starts at 168 registers a thread (384 threads);
// setmaxnreg moves 128 of each producer thread's to the consumers, which run
// at 232. (The registers setmaxnreg.inc takes come only from what the
// block's other warps release, so the producer is a whole warpgroup.) That
// budget caps a block at 128 x 64: 128 x 128 would need 2 x 3 x 128 x 128
// live f32 values, more than the SM's 64K registers; and it leaves no room
// to keep a second step's products in flight while the first is promoted
// (ptxas serializes such a pipeline), so each warpgroup alternates between
// its wgmmas and its adds, and the two warpgroups overlap each other.
//
// Epilogue. After the last modulus each consumer thread finalizes the 32
// elements whose residues it wrote, four at a time (fused_common.cuh): the
// next four's residue words are loaded while these four Garner chains run.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fused_common.cuh"
#include "hopper_ptx.cuh"

namespace hopper {

using fused::KIND_INT8;
using fused::KIND_KARATSUBA;
using fused::KIND_SQUARE;
using fused::kAccs;
using fused::kParts;
using fused::MAXN;
using fused::Moduli;

constexpr int BM = 128, BN = 64, BK = 128;  // one block's tile (KERNEL_TILE: 128 x 2BN x BK)
constexpr int CLUSTER = 2;  // blocks along n sharing (multicasting) their A tile
constexpr int KC = 1;                       // k32 steps per fresh FP8 fragment (GEMM_KC)
constexpr int CHUNK = 1 << 16;  // k of one chunk: a promoted f32 accumulator <= 2^16 * 2^8
constexpr int SLOTS = 9;
constexpr int CONSUMERS = 2;                    // warpgroups, 64 rows of the tile each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int GROUP_M = 8;                      // row tiles per raster group
constexpr int A_TILE = BM * BK, B_TILE = BN * BK;  // bytes of one part's k-tile
constexpr int SLOT_BYTES = A_TILE + B_TILE;        // one part of A and of B
constexpr int SMEM_BYTES = 1024 + SLOTS * SLOT_BYTES + 2 * SLOTS * 8 + sizeof(Moduli);
static_assert(KC == 1, "a chain of KC k32 steps must sum at most 2^13");
static_assert(BK == TMA_BOX_K, "a k-tile is one TMA box deep");
static_assert(CHUNK % BK == 0 && (CHUNK & (CHUNK - 1)) == 0,
              "a chunk is a power of two of whole k-tiles");

// -- the kernel ---------------------------------------------------------------

// TMA maps of the K-major part stacks: a[q] over (N*m, k), b[q] over
// (N*n, k) bytes; int8 uses a[0], b[0] only.
struct Maps {
  CUtensorMap a[3];
  CUtensorMap b[3];
};

struct Epilogue {
  int16_t* res;     // (N, m, n) residue scratch; the digits when out is NULL
  const int* lmu;   // (m)
  const int* lnu;   // (n)
  double* out;      // (m, n), or NULL: write the Garner digits over res
  int m, n, k;
};

struct Smem {
  uint32_t tiles;   // shared address of slot 0 (1024-aligned)
  uint32_t full;    // SLOTS mbarriers: the slot's loads landed
  uint32_t empty;   // SLOTS mbarriers: the slot's products are done
};

using Ring = RingOf<SLOTS>;

// A chunk's fold: its accumulators' centred residues into the scratch plane
// l, added mod p to the earlier chunks' there unless this is the first.
template <int KIND, typename Acc, int NA>
__device__ __forceinline__ void fold_chunk(const Acc (&acc)[NA][32], const Epilogue& ep, int l,
                                           int p, int s, int row0, int col0, bool later) {
  int16_t* plane = ep.res + static_cast<size_t>(l) * ep.m * ep.n;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int row = row0 + wg * 64 + frag_row(j), col = col0 + frag_col(j);
    uint32_t* word = reinterpret_cast<uint32_t*>(plane + static_cast<size_t>(row) * ep.n + col);
    const uint32_t before = later ? *word : 0u;
    int c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (KIND == KIND_INT8) {
        c[h] = ozaki::cmod(acc[0][j + h], p);
      } else {
        c[h] = ozaki::combine(__float2int_rn(acc[0][j + h]), __float2int_rn(acc[1][j + h]),
                              __float2int_rn(acc[2][j + h]), p, KIND == KIND_SQUARE, s);
      }
      if (later) c[h] = ozaki::cmod(c[h] + static_cast<int16_t>(before >> (16 * h)), p);
    }
    *word = (static_cast<uint32_t>(c[0]) & 0xFFFFu) | (static_cast<uint32_t>(c[1]) << 16);
  }
}

// One modulus over the whole contraction, its centred residues into the
// scratch plane l. LONG (k > CHUNK): at the end of each chunk but the last
// the accumulators fold into the plane and start again from 0, and the
// last chunk's fold adds to theirs.
template <int KIND, bool LONG>
__device__ __forceinline__ void consumer_modulus(const Smem& sm, const Epilogue& ep, int l,
                                                 int p, int s, int row0, int col0,
                                                 Ring& ring) {
  constexpr bool INT8 = KIND == KIND_INT8;
  constexpr int NA = kAccs<KIND>;
  using Acc = std::conditional_t<INT8, int, float>;
  const int wg = threadIdx.x >> 7;
  Acc acc[NA][32];
#pragma unroll
  for (int q = 0; q < NA; ++q) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[q][j] = 0;
  }
  for (int k0 = 0; k0 < ep.k; k0 += BK) {
    int slot[kParts<KIND>];
#pragma unroll
    for (int q = 0; q < kParts<KIND>; ++q) {  // part q of the k-tile
      slot[q] = ring.slot;
      mbar_wait(sm.full + 8 * ring.slot, ring.phase);
      ring.advance();
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint64_t da[kParts<KIND>], db[kParts<KIND>];
#pragma unroll
      for (int q = 0; q < kParts<KIND>; ++q) {
        const uint32_t base = sm.tiles + slot[q] * SLOT_BYTES;
        da[q] = desc_k128(base + wg * 64 * BK + kk);
        db[q] = desc_k128(base + A_TILE + kk);
      }
      wgmma_fence();
      if constexpr (INT8) {
        wgmma_s8_acc(acc[0], da[0], db[0]);
      } else {
        float f[3][32];
        if constexpr (KIND == KIND_SQUARE) {
          wgmma_e4m3_fresh(f[0], da[0], db[1]);  // A1B2
          wgmma_e4m3_fresh(f[1], da[1], db[0]);  // A2B1
          wgmma_e4m3_fresh(f[2], da[1], db[1]);  // A2B2
        } else {
#pragma unroll
          for (int q = 0; q < 3; ++q) wgmma_e4m3_fresh(f[q], da[q], db[q]);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int q = 0; q < 3; ++q) {
#pragma unroll
          for (int j = 0; j < 32; ++j) acc[q][j] = __fadd_rn(acc[q][j], f[q][j]);
        }
      }
    }
    if constexpr (INT8) {
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {  // both blocks' producers write into this slot
#pragma unroll
      for (int q = 0; q < kParts<KIND>; ++q) {
#pragma unroll
        for (int c = 0; c < CLUSTER; ++c) mbar_arrive_cluster(sm.empty + 8 * slot[q], c);
      }
    }
    if constexpr (LONG) {
      if (((k0 + BK) & (CHUNK - 1)) == 0 && k0 + BK < ep.k) {  // a chunk's last k-tile
        fold_chunk<KIND>(acc, ep, l, p, s, row0, col0, k0 >= CHUNK);
#pragma unroll
        for (int q = 0; q < NA; ++q) {
#pragma unroll
          for (int j = 0; j < 32; ++j) acc[q][j] = 0;
        }
      }
    }
  }
  fold_chunk<KIND>(acc, ep, l, p, s, row0, col0, LONG);
}

// Index in C of the first of the adjacent pair (j, j + 1) of a consumer
// thread's fragments, its warpgroup's rows starting at row0.
__device__ __forceinline__ size_t pair_index(const Epilogue& ep, int row0, int col0, int j) {
  return static_cast<size_t>(row0 + frag_row(j)) * ep.n + col0 + frag_col(j);
}

// The 32-bit words holding the residues of the pair at index i (i even) for
// every radix modulus d < MAXN, radix order; straight-line loads, so they are
// all in flight at once. Entries d >= N read plane 0 (radix_order is 0 there)
// and are never used.
__device__ __forceinline__ void residue_words(const Moduli& M, const int16_t* res, size_t plane,
                                              size_t i, uint32_t (&w)[MAXN]) {
#pragma unroll
  for (int d = 0; d < MAXN; ++d)
    w[d] = *reinterpret_cast<const uint32_t*>(res + i + M.radix_order[d] * plane);
}

// DIGITS: write the Garner digits over the scratch instead of C; LONG: the
// contraction passes one chunk. Each a separate instantiation, so that the
// f64 epilogue's registers and the single chunk's loop are as without them
// (on the H100 a runtime branch into the digits spilled, and the chunked
// loop cost a single chunk ~2.5% at 8192^3).
template <bool DIGITS, bool LONG>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
gemm_core_kernel(const __grid_constant__ Maps maps, Epilogue ep,
                 const __grid_constant__ Moduli mod) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gen = smem_raw + (base - raw);
  Smem sm{base, base + SLOTS * SLOT_BYTES, base + SLOTS * SLOT_BYTES + 8 * SLOTS};
  Moduli& M = *reinterpret_cast<Moduli*>(gen + SLOTS * SLOT_BYTES + 16 * SLOTS);
  fused::copy_moduli(M, mod);
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      // one arrival per consumer warp of each block of the cluster
      mbar_init(sm.empty + 8 * s, 4 * CONSUMERS * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every block's barriers exist before any load or remote arrival

  // grouped raster over the clusters' 128 x 128 tiles: GROUP_M row tiles
  // share their B panels in L2 while resident; the block of rank r takes
  // columns r * BN of its cluster's tile
  const uint32_t rank = cluster_rank();
  const int cid = blockIdx.x / CLUSTER;
  const int tiles_m = ep.m / BM, tiles_n = ep.n / (CLUSTER * BN);
  const int group = GROUP_M * tiles_n, first = (cid / group) * GROUP_M;
  const int rows_in_group = min(tiles_m - first, GROUP_M);
  const int row0 = (first + (cid % group) % rows_in_group) * BM;
  const int col0 = (((cid % group) / rows_in_group) * CLUSTER + rank) * BN;
  const int n_mod = M.n;

  if (threadIdx.x >= 128 * CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * CONSUMERS) {
      Ring ring;
      for (int l = 0; l < n_mod; ++l) {
        const int kind = M.kind[l];
        const int np = kind == KIND_KARATSUBA ? 3 : (kind == KIND_SQUARE ? 2 : 1);
        for (int k0 = 0; k0 < ep.k; k0 += BK) {
          for (int q = 0; q < np; ++q) {
            mbar_wait(sm.empty + 8 * ring.slot, ring.phase ^ 1);
            const uint32_t full = sm.full + 8 * ring.slot;
            const uint32_t dst = sm.tiles + ring.slot * SLOT_BYTES;
            mbar_expect_tx(full, SLOT_BYTES);  // own B, both halves of A
            const int half = rank * (BM / CLUSTER);
            tma_load_multicast(dst + half * BK, &maps.a[q], k0, l * ep.m + row0 + half, full,
                               (1u << CLUSTER) - 1);
            tma_load(dst + A_TILE, &maps.b[q], k0, l * ep.n + col0, full);
            ring.advance();
          }
        }
      }
      // stay resident until every consumer of the cluster has released every
      // slot: their arrivals land on this block's barriers
      for (int i = 0; i < SLOTS; ++i) {
        mbar_wait(sm.empty + 8 * ring.slot, ring.phase ^ 1);
        ring.advance();
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    Ring ring;
    for (int l = 0; l < n_mod; ++l) {
      const int p = M.ps[l], s = M.split_s[l];
      switch (M.kind[l]) {
        case KIND_SQUARE:
          consumer_modulus<KIND_SQUARE, LONG>(sm, ep, l, p, s, row0, col0, ring);
          break;
        case KIND_KARATSUBA:
          consumer_modulus<KIND_KARATSUBA, LONG>(sm, ep, l, p, s, row0, col0, ring);
          break;
        default:
          consumer_modulus<KIND_INT8, LONG>(sm, ep, l, p, s, row0, col0, ring);
      }
    }
    // each thread finalizes the elements whose residues it wrote, four at
    // a time (two pairs of adjacent columns, 8 rows apart): the residue
    // words of the next two pairs are loaded while these four Garner chains
    // run, interleaved; without C, the digits go over the residues
    const size_t plane = static_cast<size_t>(ep.m) * ep.n;
    const int wg = threadIdx.x >> 7;
    const int wrow0 = row0 + wg * 64;
    uint32_t w[2][MAXN], next[2][MAXN] = {};
    for (int h = 0; h < 2; ++h)
      residue_words(M, ep.res, plane, pair_index(ep, wrow0, col0, 2 * h), w[h]);
    for (int j = 0; j < 32; j += 4) {
      if (j + 4 < 32) {
        for (int h = 0; h < 2; ++h)
          residue_words(M, ep.res, plane, pair_index(ep, wrow0, col0, j + 4 + 2 * h), next[h]);
      }
      int t[4][MAXN], e[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int d = 0; d < MAXN; ++d) {
          t[2 * h][d] = static_cast<int16_t>(w[h][d] & 0xFFFFu);
          t[2 * h + 1][d] = static_cast<int16_t>(w[h][d] >> 16);
          w[h][d] = next[h][d];
        }
        const int row = wrow0 + frag_row(j + 2 * h), col = col0 + frag_col(j + 2 * h);
        e[2 * h] = -(ep.lmu[row] + ep.lnu[col]);
        e[2 * h + 1] = -(ep.lmu[row] + ep.lnu[col + 1]);
      }
      if constexpr (!DIGITS) {
        double v[4];
        fused::finalize<4>(M, t, e, v);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wrow0 + frag_row(j + 2 * h), col = col0 + frag_col(j + 2 * h);
          *reinterpret_cast<double2*>(ep.out + static_cast<size_t>(row) * ep.n + col) =
              make_double2(v[2 * h], v[2 * h + 1]);
        }
      } else {
        // the digits (K5's digits mode), radix order, over these elements'
        // residues, which this thread alone has read, and read already
        float dg[4][MAXN];
        fused::garner<4>(M, t, dg);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t i = pair_index(ep, wrow0, col0, j + 2 * h);
#pragma unroll
          for (int d = 0; d < MAXN; ++d) {
            if (d < n_mod) {
              *reinterpret_cast<uint32_t*>(ep.res + i + d * plane) =
                  (static_cast<uint32_t>(ozaki::small_to_int(dg[2 * h][d])) & 0xFFFFu) |
                  (static_cast<uint32_t>(ozaki::small_to_int(dg[2 * h + 1][d])) << 16);
            }
          }
        }
      }
    }
  }
}

// -- host side ----------------------------------------------------------------

// Launch the core on `stream`: parts a[q] (N, m, k) and b[q] (N, n, k),
// K-major, 16-byte aligned (a[1..2], b[1..2] NULL for int8; hs planes of
// square moduli never read); res an (N, m, n) int16 scratch, which gets the
// Garner digits (radix order) where out is NULL; m, n, k multiples of (BM,
// BN, BK). Returns the CUDA error (0 on success).
inline int gemm_core_launch(const uint8_t* const a[3], const uint8_t* const b[3], const int* lmu,
                            const int* lnu, int16_t* res, double* out, int m, int n, int k,
                            const Moduli& mod, int device, cudaStream_t stream) {
  if (mod.n < 1 || mod.n > MAXN || m <= 0 || n <= 0 || k <= 0 || m % BM || n % (CLUSTER * BN) ||
      k % BK ||
      static_cast<long long>(mod.n) * m > 0x7FFFFFFFLL ||
      static_cast<long long>(mod.n) * n > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int np = mod.kind[0] == KIND_INT8 ? 1 : 3;
  return fused::on_device(device, [&]() {
    Maps maps{};
    for (int q = 0; q < np; ++q) {
      if (!a[q] || !b[q] ||
          !make_map(&maps.a[q], a[q], static_cast<long long>(mod.n) * m, k, BM / CLUSTER) ||
          !make_map(&maps.b[q], b[q], static_cast<long long>(mod.n) * n, k, BN))
        return cudaErrorInvalidValue;
    }
    const long long blocks = static_cast<long long>(m / BM) * (n / BN);
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    const bool long_k = k > CHUNK;
    auto kern = out ? (long_k ? gemm_core_kernel<false, true> : gemm_core_kernel<false, false>)
                    : (long_k ? gemm_core_kernel<true, true> : gemm_core_kernel<true, false>);
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const Epilogue ep{res, lmu, lnu, out, m, n, k};
    kern<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, stream>>>(maps, ep, mod);
    return cudaGetLastError();
  });
}

}  // namespace hopper
