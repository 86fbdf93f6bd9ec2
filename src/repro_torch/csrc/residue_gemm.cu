// The low-precision residue GEMMs of the phase-split Ozaki-II pipeline, for
// Hopper (sm_90a). One source, two entry points:
//
//   fp8_gemm  (K3) replaces repro/kernels/fp8_gemm/kernel.py::fp8_gemm
//             (body _gemm_kernel): e4m3 A (m, k) @ e4m3 B (k, n) -> f32 C;
//   int8_gemm (K4) replaces repro/kernels/int8_gemm/kernel.py::int8_gemm
//             (body _gemm_kernel): int8 A @ int8 B -> int32 C.
//
// The operands are one modulus' residue parts (|x| <= 16 in e4m3, |x| <= 128
// in int8): A (m, k) row-major and B K-MAJOR, as its transpose B^T (n, k)
// row-major (wgmma takes 8-bit operands only K-major; the pipeline makes
// B's parts K-major in the first place). C is one plane of the (N, m, n)
// product stack the requant/Garner pass (K5) reads. Two routes, chosen by
// the wrapper from k and the operands' alignment alone:
//
// wgmma (k % 16 == 0, A and B^T 16-byte aligned: what TMA can address).
// Warpgroup 2 of each block is the producer: one thread issues the TMA loads
// of A's and B^T's 128-deep k-tiles (128-byte swizzle) into a ring of SLOTS
// shared-memory slots with full/empty mbarriers. One TMA map per operand
// PLANE, so the zero fill past its edges masks ragged m, n and k (a map over
// the whole (N*m, k) stack would read the next modulus' rows into a ragged
// tile). A cluster of two blocks along n shares its A tile: each block loads
// one 64-row half and multicasts it into both, so the cluster covers 128 x
// 2WN of C and L2 carries mnk (1/(2WN) + 1/128) bytes, 6.4 GB for one
// 8192^3 product at WN = 128 against 8.6 GB for plain 128 x 128 blocks.
// Warpgroups 0-1 are the consumers, 64 rows of the block's 128 x WN tile
// each, wgmma m64nWNk32 with both operands from shared memory; C leaves
// the registers masked at the edge.
//
// mma_sync (every other k or alignment: odd problem sizes, misaligned
// views): one block of 8 warps per 128 x 128 tile, each warp 64 x 32 (4 x 4
// m16n8k32 tiles), 64-deep k-tiles of A and B^T copied byte by byte (masked)
// to shared memory through __syncthreads.
//
// Exactness. FP8 (K3): each k32 step's product goes into a FRESH f32
// fragment (scale-d = 0; mma_sync: a zero fragment converted to int32), so a
// step sums at most 32 * 16 * 16 = 2^13 in the tensor core: Hopper's chained
// FP8 wgmma accumulator left the exact sum after 16 k32 steps (the wgmma
// probe of fused_raw.cu), so the promotion interval is KC = 1 step. The
// fragment is added with __fadd_rn into the f32 accumulator, exact while
// |sum| <= k * 2^8 <= 2^24 (k <= 2^16, the wrapper's limit); C = that sum.
// int8 (K4): the s8 products accumulate in s32 over the whole k (|sum| <=
// k * 127^2 < 2^31 for k <= 2^17, the wrapper's limit and the reference's),
// with no promotion.
//
// Overlap (K3). Each k32 step costs the consumer warpgroup one wgmma and
// 64 FP32 adds a thread (mnk/32 = 1.7e10 adds for one 8192^3 product, as
// many issue slots as the tensor work takes cycles), and ptxas lets no
// instruction touch a fragment while any wgmma of its warpgroup is in flight
// (it serialized a two-fragment pipeline, C7514, and spilled). So each
// warpgroup waits for its product before promoting it, and the two
// consumer warpgroups overlap one another's products and adds. A thread
// holds 64 accumulators and one 64-register fragment; setmaxnreg moves the
// producer's registers to the consumers (40 / 232 a thread). K4 has no
// fragments: its s8 products chain on the accumulator with one k-tile's
// group in flight, on the wider m64n256 tile (WN = 256, a 128 x 512 cluster).
//
// Bound. 2mnk FP8 (int8) tensor operations against the dense 1,979 TOP/s,
// and (mk + kn) bytes in, 4mn out: the operations bound it at the main
// path's shapes.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fused_common.cuh"
#include "hopper_ptx.cuh"

namespace {

using namespace fused;
using namespace hopper;

// ---- the wgmma route ----------------------------------------------------------

constexpr int WG_BM = 128;        // block tile rows: two consumer warpgroups of 64
constexpr int WG_BK = TMA_BOX_K;  // k-tile depth (bytes)
constexpr int WG_CLUSTER = 2;     // blocks along n sharing (multicasting) their A tile
constexpr int WG_CONSUMERS = 2;
constexpr int WG_THREADS = 128 * (WG_CONSUMERS + 1);  // + the producer warpgroup
constexpr int WG_GROUP_M = 8;                         // row tiles per raster group
constexpr int KC = 1;  // k32 steps per fresh FP8 fragment
static_assert(KC == 1, "a chain of KC k32 steps must sum at most 2^13");

// The block tile is 128 x WN: K3 128 x 128, K4 (no fragments) 128 x 256. One
// ring slot holds a k-tile of A (128 rows) and of B^T (WN rows), as many
// slots as fit in 200 KB.
template <bool INT8>
struct Cfg {
  static constexpr int WN = INT8 ? 256 : 128;
  static constexpr int A_TILE = WG_BM * WG_BK, B_TILE = WN * WG_BK;
  static constexpr int SLOT_BYTES = A_TILE + B_TILE;
  static constexpr int SLOTS = 200 * 1024 / SLOT_BYTES;
  static constexpr int SMEM_BYTES = 1024 + SLOTS * SLOT_BYTES + 2 * SLOTS * 8;
};

// One TMA map per operand plane: A (m, k) in boxes of 64 rows (a block's
// half of its cluster's A tile), B^T (n, k) in boxes of WN rows.
struct PlaneMaps {
  CUtensorMap a;
  CUtensorMap b;
};

struct Shape {
  void* out;  // C (m, n): float (K3) or int (K4), row stride n
  int m, n, k;
};

// A consumer warpgroup's release of a slot: one arrival per warp on the
// slot's empty barrier in each block of the cluster (both producers write
// into it).
__device__ __forceinline__ void release_slot(uint32_t empty, int slot) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < WG_CLUSTER; ++c) mbar_arrive_cluster(empty + 8 * slot, c);
  }
}

// K3's consumer loop: each k32 step's e4m3 product goes into a fresh
// fragment, and once it has landed it is promoted into the f32
// accumulator. No instruction touches the fragment while its wgmma is in
// flight: ptxas serializes a wgmma pipeline around any such access (C7514),
// so the two consumer warpgroups overlap one another's products and adds
// instead. A slot is released after its last step.
template <int SLOTS, int SLOT_BYTES, int A_TILE>
__device__ __forceinline__ void consume_fp8(float (&acc)[64], uint32_t tiles, uint32_t full,
                                            uint32_t empty, int k_tiles) {
  const int wg = threadIdx.x >> 7;
  float f[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  RingOf<SLOTS> ring;
  for (int t = 0; t < k_tiles; ++t) {
    const int slot = ring.slot;
    mbar_wait(full + 8 * slot, ring.phase);
    ring.advance();
    const uint32_t a_base = tiles + slot * SLOT_BYTES + wg * 64 * WG_BK;
    const uint32_t b_base = tiles + slot * SLOT_BYTES + A_TILE;
#pragma unroll
    for (int kk = 0; kk < WG_BK; kk += 32) {
      wgmma_fence();
      wgmma_e4m3_n128_fresh(f, desc_k128(a_base + kk), desc_k128(b_base + kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(f);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = __fadd_rn(acc[j], f[j]);
    }
    release_slot(empty, slot);
  }
}

// K4's consumer loop: the s8 products of every k-tile chained on the s32
// accumulator (the first with scale-d = 0, so no other instruction writes
// it); one k-tile's group stays in flight while the previous k-tile's slot
// is released.
template <int SLOTS, int SLOT_BYTES, int A_TILE>
__device__ __forceinline__ void consume_int8(int (&acc)[128], uint32_t tiles, uint32_t full,
                                             uint32_t empty, int k_tiles) {
  const int wg = threadIdx.x >> 7;
  RingOf<SLOTS> ring;
  int prev = 0;
  for (int t = 0; t < k_tiles; ++t) {
    const int slot = ring.slot;
    mbar_wait(full + 8 * slot, ring.phase);
    ring.advance();
    const uint32_t a_base = tiles + slot * SLOT_BYTES + wg * 64 * WG_BK;
    const uint32_t b_base = tiles + slot * SLOT_BYTES + A_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK; kk += 32)
      wgmma_s8_n256(acc, desc_k128(a_base + kk), desc_k128(b_base + kk), t > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-tile's products have landed
    if (t > 0) release_slot(empty, prev);
    prev = slot;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release_slot(empty, prev);
}

// C's 64 x WN tile of one consumer warpgroup from its R = WN / 2 registers,
// masked at the edge: adjacent pairs as one 8-byte store where n and C's
// base allow it.
template <typename T, int R>
__device__ __forceinline__ void store_tile(const Shape& sh, const T (&acc)[R], int row0,
                                           int col0) {
  T* out = static_cast<T*>(sh.out);
  const bool pairs = sh.n % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
#pragma unroll
  for (int j = 0; j < R; j += 2) {
    const int row = row0 + frag_row(j), col = col0 + frag_col(j);
    if (row >= sh.m || col >= sh.n) continue;
    T* p = out + static_cast<size_t>(row) * sh.n + col;
    if (pairs) {
      if constexpr (std::is_same_v<T, float>) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[j], acc[j + 1]);
      } else {
        *reinterpret_cast<int2*>(p) = make_int2(acc[j], acc[j + 1]);
      }
    } else {
      p[0] = acc[j];
      if (col + 1 < sh.n) p[1] = acc[j + 1];
    }
  }
}

template <bool INT8>
__global__ void __cluster_dims__(WG_CLUSTER, 1, 1) __launch_bounds__(WG_THREADS, 1)
residue_gemm_wgmma_kernel(const __grid_constant__ PlaneMaps maps, Shape sh) {
  using L = Cfg<INT8>;
  constexpr int WN = L::WN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t tiles = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = tiles + L::SLOTS * L::SLOT_BYTES, empty = full + 8 * L::SLOTS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::SLOTS; ++s) {
      mbar_init(full + 8 * s, 1);
      // one arrival per consumer warp of each block of the cluster
      mbar_init(empty + 8 * s, 4 * WG_CONSUMERS * WG_CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every block's barriers exist before any load or remote arrival

  // grouped raster over the clusters' 128 x 2WN tiles: WG_GROUP_M row tiles
  // share their B panels in L2 while resident; the block of rank r takes
  // columns r * WN of its cluster's tile
  const uint32_t rank = cluster_rank();
  const int cid = blockIdx.x / WG_CLUSTER;
  const int tiles_m = (sh.m + WG_BM - 1) / WG_BM;
  const int tiles_n = (sh.n + WG_CLUSTER * WN - 1) / (WG_CLUSTER * WN);
  const int group = WG_GROUP_M * tiles_n, first = (cid / group) * WG_GROUP_M;
  const int rows_in_group = min(tiles_m - first, WG_GROUP_M);
  const int row0 = (first + (cid % group) % rows_in_group) * WG_BM;
  const int col0 = (((cid % group) / rows_in_group) * WG_CLUSTER + rank) * WN;
  const int k_tiles = (sh.k + WG_BK - 1) / WG_BK;

  if (threadIdx.x >= 128 * WG_CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * WG_CONSUMERS) {
      RingOf<L::SLOTS> ring;
      const int half = rank * (WG_BM / WG_CLUSTER);
      for (int t = 0; t < k_tiles; ++t) {
        mbar_wait(empty + 8 * ring.slot, ring.phase ^ 1);
        const uint32_t bar = full + 8 * ring.slot;
        const uint32_t dst = tiles + ring.slot * L::SLOT_BYTES;
        mbar_expect_tx(bar, L::SLOT_BYTES);  // own B^T, both halves of A
        tma_load_multicast(dst + half * WG_BK, &maps.a, t * WG_BK, row0 + half, bar,
                           (1u << WG_CLUSTER) - 1);
        tma_load(dst + L::A_TILE, &maps.b, t * WG_BK, col0, bar);
        ring.advance();
      }
      // stay resident until every consumer of the cluster has released every
      // slot: their arrivals land on this block's barriers
      for (int i = 0; i < L::SLOTS; ++i) {
        mbar_wait(empty + 8 * ring.slot, ring.phase ^ 1);
        ring.advance();
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wrow0 = row0 + (threadIdx.x >> 7) * 64;
    if constexpr (INT8) {
      int acc[WN / 2];
      consume_int8<L::SLOTS, L::SLOT_BYTES, L::A_TILE>(acc, tiles, full, empty, k_tiles);
      store_tile(sh, acc, wrow0, col0);
    } else {
      float acc[WN / 2];
      consume_fp8<L::SLOTS, L::SLOT_BYTES, L::A_TILE>(acc, tiles, full, empty, k_tiles);
      store_tile(sh, acc, wrow0, col0);
    }
  }
}

template <bool INT8>
int launch_wgmma(const uint8_t* a, const uint8_t* bt, void* out, int m, int n, int k,
                 int device, cudaStream_t stream) {
  using L = Cfg<INT8>;
  constexpr int WN = L::WN;
  if (k % 16 || reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(bt) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long clusters = static_cast<long long>((m + WG_BM - 1) / WG_BM) *
                             ((n + WG_CLUSTER * WN - 1) / (WG_CLUSTER * WN));
  if (clusters * WG_CLUSTER > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&]() {
    PlaneMaps maps{};
    if (!make_map(&maps.a, a, m, k, WG_BM / WG_CLUSTER) || !make_map(&maps.b, bt, n, k, WN))
      return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(residue_gemm_wgmma_kernel<INT8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    residue_gemm_wgmma_kernel<INT8>
        <<<static_cast<unsigned>(clusters * WG_CLUSTER), WG_THREADS, L::SMEM_BYTES, stream>>>(
            maps, Shape{out, m, n, k});
    return cudaGetLastError();
  });
}

// ---- the mma_sync route ---------------------------------------------------------

constexpr int TM = 128, TN = 128;      // output tile; BK = 64 (fused_common.cuh)
constexpr int TILE_BYTES = 128 * LDS;  // one operand's k-tile in shared memory

// The k-tile (rows row0..row0+127, k bytes k0..k0+63) of a K-major operand
// (rows x k bytes: A, or B^T) into dst ([128][LDS]): each thread 2 rows x 16
// bytes, read byte by byte. Out-of-range bytes are 0.
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* src, int rows, int k,
                                          int row0, int k0) {
  const int c = (threadIdx.x & 3) * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (threadIdx.x >> 2) + 64 * h;
    const int row = row0 + r;
    uint32_t w[4] = {0, 0, 0, 0};
    if (row < rows) {
      const uint8_t* p = src + static_cast<size_t>(row) * k;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (k0 + c + j < k) w[j >> 2] |= static_cast<uint32_t>(p[k0 + c + j]) << (8 * (j & 3));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 2)
residue_gemm_mma_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
                        void* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) uint8_t a_s[TILE_BYTES];
  __shared__ __align__(16) uint8_t b_s[TILE_BYTES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;

  int acc[4][4][4] = {};
  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();  // the previous k-tile is consumed
    load_tile(a_s, a, m, k, row0, k0);
    load_tile(b_s, bt, n, k, col0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        load_a(af[i], a_s + (wm + 16 * i) * LDS + kk, lane);
        load_b(bf[i], b_s + (wn + 8 * i) * LDS + kk, lane);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (INT8) {
            mma_s8(acc[mi][ni], af[mi], bf[ni]);
          } else {
            mma_k32_exact(acc[mi][ni], af[mi], bf[ni]);
          }
        }
      }
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = row0 + wm + 16 * mi + g + 8 * (q >> 1);
        const int col = col0 + wn + 8 * ni + 2 * t + (q & 1);
        if (row >= m || col >= n) continue;
        const size_t i = static_cast<size_t>(row) * n + col;
        if constexpr (INT8) {
          static_cast<int*>(out)[i] = acc[mi][ni][q];
        } else {
          static_cast<float*>(out)[i] = static_cast<float>(acc[mi][ni][q]);
        }
      }
    }
  }
}

template <bool INT8>
int launch_mma(const uint8_t* a, const uint8_t* bt, void* out, int m, int n, int k, int device,
               cudaStream_t stream) {
  if ((m + TM - 1) / TM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  return on_device(device, [&]() {
    residue_gemm_mma_kernel<INT8><<<grid, THREADS, 0, stream>>>(a, bt, out, m, n, k);
    return cudaGetLastError();
  });
}

template <bool INT8>
int launch(const void* a, const void* bt, void* out, int m, int n, int k, int wgmma, int device,
           void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(bt);
  auto s = static_cast<cudaStream_t>(stream);
  return wgmma ? launch_wgmma<INT8>(pa, pb, out, m, n, k, device, s)
               : launch_mma<INT8>(pa, pb, out, m, n, k, device, s);
}

}  // namespace

extern "C" {

// Launch on `stream`: C (m x n, f32, row stride n) = A (m x k, e4m3 bytes,
// row-major) @ B, given K-major as bt = B^T (n x k, e4m3 bytes, row-major),
// all device pointers. `wgmma` != 0 takes the wgmma route and requires
// k % 16 == 0 and A and bt 16-byte aligned; 0 takes the mma_sync route.
// Returns the CUDA error of the launch (0 on success).
int fp8_gemm_launch(const void* a, const void* bt, float* out, int m, int n, int k, int wgmma,
                    int device, void* stream) {
  return launch<false>(a, bt, out, m, n, k, wgmma, device, stream);
}

// The same for int8 A and B^T and an int32 C.
int int8_gemm_launch(const void* a, const void* bt, int* out, int m, int n, int k, int wgmma,
                     int device, void* stream) {
  return launch<true>(a, bt, out, m, n, k, wgmma, device, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
