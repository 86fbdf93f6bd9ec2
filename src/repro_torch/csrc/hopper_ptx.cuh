// The generic Hopper (sm_90a) pieces of the port's hand-written GEMMs, shared
// by the fused kernels' GEMM core (hopper_gemm.cuh: K1, K2) and the residue
// GEMMs of the phase-split pipeline (residue_gemm.cu: K3, K4):
//
//   PTX wrappers for mbarriers, clusters, TMA loads (plain and multicast),
//   wgmma shared-memory descriptors (K-major, 128-byte swizzle) and the
//   wgmma products of 8-bit operands (e4m3 into a fresh f32 fragment, s8
//   added to an s32 accumulator; wgmma takes 8-bit operands only K-major);
//   the ring position of a pipeline of shared-memory slots; the accumulator
//   fragment layout; and on the host, the TMA map of a K-major byte matrix.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

constexpr int TMA_BOX_K = 128;  // bytes of k in one TMA box: one 128-byte swizzled row

// -- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of `bar` with the given parity to complete. A wait of
// more than ~2^34 cycles (seconds) can only be a broken pipeline: it traps,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 34)) {
      __trap();
    }
  }
}

// Arrive on the barrier at the same shared offset in block `cta` of the
// cluster (this block included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 r;\n"
      "mapa.shared::cluster.u32 r, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [r];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// TMA: the box at (c0 = k byte, c1 = row) of a 2-D map into shared memory,
// completing on `bar`; tma_load_multicast writes it at the same offset into
// every block of `mask` in the cluster and completes on each one's `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 bytes, 8-row groups 1024
// bytes apart (SBO), the leading offset unused; the tile base 1024-aligned,
// a k32 step inside the row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers at this point of the program: a read of a wgmma's output
// cannot be hoisted above the wait that precedes this, nor a write of it sunk
// below the wgmma that follows.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HG_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HG_OUT32(c, d)                                                                    \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]),        \
      c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]),      \
      c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]),     \
      c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])

// One e4m3 m64n64k32 product into a fresh f32 fragment d (scale-d = 0).
__device__ __forceinline__ void wgmma_e4m3_fresh(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 " HG_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : HG_OUT32("=f", d)
      : "l"(da), "l"(db), "r"(0));
}

// One s8 m64n64k32 product added to the s32 accumulator d (scale-d = 1).
__device__ __forceinline__ void wgmma_s8_acc(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " HG_D32 ", %32, %33, p;\n}\n"
      : HG_OUT32("+r", d)
      : "l"(da), "l"(db), "r"(1));
}

#define HG_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, " \
  "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define HG_OUT64(c, d) \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), \
  c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), \
  c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), \
  c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), \
  c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), \
  c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), \
  c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]), \
  c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])

#define HG_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, " \
  "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, " \
  "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, " \
  "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, " \
  "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, " \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, " \
  "%123, %124, %125, %126, %127}"

#define HG_OUT128(c, d) \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), \
  c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), \
  c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), \
  c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), \
  c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), \
  c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), \
  c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]), \
  c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63]), c(d[64]), \
  c(d[65]), c(d[66]), c(d[67]), c(d[68]), c(d[69]), c(d[70]), c(d[71]), c(d[72]), \
  c(d[73]), c(d[74]), c(d[75]), c(d[76]), c(d[77]), c(d[78]), c(d[79]), c(d[80]), \
  c(d[81]), c(d[82]), c(d[83]), c(d[84]), c(d[85]), c(d[86]), c(d[87]), c(d[88]), \
  c(d[89]), c(d[90]), c(d[91]), c(d[92]), c(d[93]), c(d[94]), c(d[95]), c(d[96]), \
  c(d[97]), c(d[98]), c(d[99]), c(d[100]), c(d[101]), c(d[102]), c(d[103]), \
  c(d[104]), c(d[105]), c(d[106]), c(d[107]), c(d[108]), c(d[109]), c(d[110]), \
  c(d[111]), c(d[112]), c(d[113]), c(d[114]), c(d[115]), c(d[116]), c(d[117]), \
  c(d[118]), c(d[119]), c(d[120]), c(d[121]), c(d[122]), c(d[123]), c(d[124]), \
  c(d[125]), c(d[126]), c(d[127])

// One e4m3 m64n128k32 product into a fresh f32 fragment d (scale-d = 0).
__device__ __forceinline__ void wgmma_e4m3_n128_fresh(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 " HG_D64
      ", %64, %65, p, 1, 1;\n}\n"
      : HG_OUT64("=f", d)
      : "l"(da), "l"(db), "r"(0));
}

// One s8 m64n256k32 product into the s32 accumulator d: d = A B + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " HG_D128 ", %128, %129, p;\n}\n"
      : HG_OUT128("+r", d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// -- pipeline and fragment layout ----------------------------------------------

// A position in a ring of SLOTS shared-memory slots: the slot and the parity
// of its current phase.
template <int SLOTS>
struct RingOf {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++slot == SLOTS) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Accumulator register j of a consumer thread -> (row, col) in its
// warpgroup's 64 x N tile: the m64nNk32 fragment layout, warp w of the group
// owning rows 16w..16w+15, registers j and j + 1 adjacent columns.
__device__ __forceinline__ int frag_row(int j) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  return 16 * w + (lane >> 2) + 8 * ((j >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int j) {
  return 8 * (j >> 2) + 2 * (threadIdx.x & 3) + (j & 1);
}

// -- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The TMA map of a K-major byte matrix of `rows` rows of k bytes (row stride
// k, a multiple of 16; base 16-byte aligned): boxes of box_rows x TMA_BOX_K
// bytes, 128-byte swizzle; boxes past the edge are zero-filled.
inline bool make_map(CUtensorMap* map, const uint8_t* base, long long rows, int k, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {TMA_BOX_K, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<uint8_t*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
