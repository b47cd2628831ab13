// Helpers for kernels that use what Hopper (sm_90a) added: mbarriers, the
// Tensor Memory Accelerator (TMA), warpgroup matrix products (wgmma), and
// the Ampere-era cp.async copies. Each wraps one or a few PTX
// instructions; the comments say what the caller must guarantee.
//
// Shared-memory tiles read by wgmma use the hardware swizzle that TMA
// writes (CU_TENSOR_MAP_SWIZZLE_64B / _128B): rows of `swizzle` bytes,
// 8 rows forming one atom of 8 * swizzle bytes, which must start at an
// address aligned to the atom (1,024 bytes for 128-byte rows).
#pragma once

#include <cstdint>

#include <cuda.h>          // CUtensorMap and its enums (no -lcuda: see below)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

// The 32-bit shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

// Initialises the barrier at `bar` for `count` arrivals per phase. One
// thread calls it; then fence_barrier_init() and a __syncthreads() before
// any thread uses the barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes barrier initialisations visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on `bar`.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival on `bar` that also tells it to expect `bytes` more bytes of
// asynchronous copies (TMA) before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed (the
// k-th completion of a barrier has parity k & 1, counting from 0).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------

// Copies the box at coordinates (c0, c1, c2, c3) (innermost first, in
// elements) of the 4-D tensor described by `map` into shared memory at
// `dst`, and counts its bytes on `bar` (which must expect them). Elements
// outside the tensor arrive as zeros. One thread starts it. `map` must
// live in kernel parameter space (a `const __grid_constant__ CUtensorMap`
// parameter) or in global memory.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// The 64-bit shared-memory matrix descriptor of a wgmma operand whose tile
// starts at `p`, stored with the hardware swizzle of `swizzle` bytes (32,
// 64 or 128; rows of that many bytes). `lbo` and `sbo` are byte offsets:
//   K-major operand (K contiguous): sbo = 8 * swizzle, from one group of 8
//     rows to the next; lbo unused. Step K by 16 elements: p += 32 bytes.
//   MN-major operand (M or N contiguous): sbo = 8 * swizzle, from one group
//     of 8 K-rows to the next; lbo from one swizzle-wide block of columns
//     to the next. Step K by 16 rows: p += 16 * swizzle bytes.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// Orders this thread's register and shared-memory writes before the
// wgmma instructions that follow (needed before the first wgmma, and
// whenever the accumulator or an A fragment was written by other code).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Closes the group of wgmma instructions started since the last commit.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins every register of `r` at this point: the compiler may neither move
// its reads or writes across this point nor keep a copy elsewhere, so code
// between issuing a wgmma that writes `r` and waiting for it does not
// touch it. Call it after starting the wgmma and after the wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x by the special-function unit alone (ex2.approx.ftz: relative error
// about 2^-22, subnormal results flushed to 0), without the extra
// instructions exp2f spends on subnormals.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one register of two bf16 (lo in the low half), rounded to
// nearest: the A-fragment element pair of a register-A wgmma.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator of a m64nN wgmma, per thread t of the warpgroup (warp w
// = t / 32, lane l): d[4 j + 2 i + c] holds row 16 w + l / 4 + 8 i, column
// 8 j + 2 (l % 4) + c. The A fragment of a register-A wgmma (64 x 16)
// takes the same layout: a[0..3] pack columns (0, 1) of row i = 0, of row
// i = 1, then columns (8, 9) of each, relative to 2 (l % 4); so the
// accumulator of one product is the A operand of the next without moving
// data between threads.

// d (m64n64, float32) = A (64 x 16, shared memory, K-major) * B (16 x
// 64, shared memory, K-major) + (accumulate ? d : 0), bf16 inputs.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t a_desc,
                                                   uint64_t b_desc,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d (m64n32, float32) = A (64 x 16, bf16 pairs in registers, laid out
// as the accumulator's fragment) * B (16 x 32, shared memory, MN-major) +
// (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_rs_m64n32k16(float* d, const uint32_t* a,
                                                   uint64_t b_desc,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, "
      "%20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// d (m64n64, float32) = A (64 x 16, bf16 pairs in registers, laid out
// as the accumulator's fragment) * B (16 x 64, shared memory, MN-major) +
// (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a,
                                                   uint64_t b_desc,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, "
      "%36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// d (m64n128, float32) = A (64 x 16, bf16 pairs in registers, laid out
// as the accumulator's fragment) * B (16 x 128, shared memory, MN-major) +
// (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a,
                                                   uint64_t b_desc,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, "
      "%68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// ---- warp-level matrix products (mma.sync, ldmatrix) -------------------------

// Fragments of mma.m16n8k16 per lane l of a warp, g = l / 4, t = l % 4; a
// register of two bf16 holds the lower column (or K index) in its low half.
//   A (16 x 16, row-major): a[0] row g, columns 2t, 2t+1; a[1] row g + 8;
//     a[2] row g, columns 2t + 8, 2t + 9; a[3] row g + 8, columns 2t + 8..9.
//   B (16 x 8): b[0] rows (K) 2t, 2t+1 of column g; b[1] rows 2t + 8..9.
//   C, D (16 x 8, float32): d[0], d[1] row g, columns 2t, 2t+1; d[2], d[3]
//     row g + 8.
// So the accumulators of two neighbouring n8 tiles, rounded pairwise to
// bf16, are the A fragment of the next product over those 16 columns:
// a = {pack(d0[0], d0[1]), pack(d0[2], d0[3]), pack(d1[0], d1[1]),
// pack(d1[2], d1[3])}.

// d += a * b: one m16n8k16 product, bf16 inputs, float32 accumulator.
// Not volatile: it reads and writes registers only, so the compiler may
// schedule it between the fragment loads.
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Loads four 8 x 8 matrices of 16-bit elements from shared memory: lanes
// 8i .. 8i + 7 give the addresses of rows 0..7 of matrix i (16 bytes each,
// 16-byte aligned), and r[i] of lane l receives row l / 4, elements 2 (l %
// 4) and 2 (l % 4) + 1 of matrix i: the fragment layout above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// As ldmatrix_x4, each matrix transposed: r[i] of lane l receives rows
// 2 (l % 4) and 2 (l % 4) + 1 (low half first) of column l / 4 of matrix
// i. So a tile stored with its K index along rows gives B (or A)
// fragments without a transposing copy.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The two floats of a register of two bf16 (low half first).
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---- programmatic dependent launch -----------------------------------------

// Lets the next kernel on the stream, when launched with programmatic
// stream serialization, start its CTAs once every CTA of this grid has
// called this (or exited), instead of when this grid has finished.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Waits until the grids this one depends on have completed and their
// writes are visible. A kernel launched with programmatic stream
// serialization calls it before it reads what the previous kernel writes.
__device__ __forceinline__ void wait_dependencies() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- cp.async ---------------------------------------------------------------

// Copies 16 bytes from global `src` to shared `dst` asynchronously; with
// `src_bytes` < 16 the rest of the 16 bytes is zero-filled (0: all zero,
// and nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Closes the group of cp.async copies started since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed cp.async groups of this thread are still
// in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- host: tensor maps ------------------------------------------------------

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so
// that the library needs no -lcuda at link time. Null if the driver has
// none.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Encodes the tensor map of a 4-D bf16 tensor at `base`: `geometry` holds
// its dims (innermost first, in elements), the byte strides of dims 1 to 3
// (16-byte multiples) and the box (innermost first); the box's inner
// extent in bytes is the swizzle (64 or 128). Returns false if the driver
// refuses it.
inline bool encode_bf16_4d(CUtensorMap* map, const void* base,
                           const int64_t* geometry) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(geometry[i]);
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(geometry[4 + i]);
  for (int i = 0; i < 4; ++i) box[i] = static_cast<cuuint32_t>(geometry[7 + i]);
  const int swizzle = static_cast<int>(box[0]) * 2;
  const CUtensorMapSwizzle mode = swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, mode,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
