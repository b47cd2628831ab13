// Blocked causal / sliding-window GQA attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py, `_kernel`): for
// each query row, softmax(q . k^T * scale) . v over the keys it may see,
// with an online softmax that keeps the running max m, the running sum l
// and the output accumulator in float32, so the (Sq, Skv) score matrix
// never reaches device memory. Query head h reads KV head h * Hkv / H: the
// grouped heads share one copy of K and V, with no repeated-KV tensor.
//
//   key j is visible to query i (global position i + q_offset) iff
//     j < Skv  and  (!causal or j <= i + q_offset)
//              and  (!window or j >  i + q_offset - window)
//
// The final division is by max(l, 1e-30), as in the Pallas kernel. Keys
// are masked by length (j < Skv), so S need not be a multiple of a tile and
// the wrapper neither pads nor slices; key tiles that lie wholly outside
// the causal / window band of a query tile are skipped; tensors are read
// through their strides, in the model's (B, S, H, D) layout. None of this
// changes the result on rows that see at least one key.
//
// Instances: q/k head dim D and v head dim Dv of (32, 32), (64, 64), (128,
// 128), MLA's (96, 64) (MiniCPM3: qk_nope 64 + qk_rope 32; v 64) and (192,
// 128) (DeepSeek-V2-Lite: qk_nope 128 + qk_rope 64; v 128), and Zamba2's
// (112, 112): the scores take D, the values and the output Dv.
//
// Bound: operations at Llama-3-8B's serving shape (1, 32 heads over 8, S =
// 1,024, head_dim 128, causal): the work is 2 * (D + Dv) per (query,
// visible key), 8.6 GFLOP against 16.8 MB of bf16 in and out, 8.694 us on
// the bf16 tensor cores (989 TFLOP/s) against 5.0 us of bytes. Bytes at
// MiniCPM3's (1, 40 heads over 40, S = 1,024, 96 / 64, causal): 26.2 MB,
// 7.82 us at 3.35 TB/s, against 6.72 GFLOP, 6.79 us (no grouped heads
// share a K or V tile there). Bytes at Zamba2's shared block (1, 32 heads
// over 32, S = 1,024, 112, causal): 29.4 MB, 8.77 us, against 7.5 GFLOP,
// 7.6 us. Operations at DeepSeek-V2-Lite's (1, 16 heads over 16, S =
// 4,096, 192 / 128, causal): 85.9 GFLOP, 86.9 us, against 83.9 MB, 25.0 us.
//
// Two kernels, chosen by dtype:
//
// bfloat16 (`flash_attention_tc_kernel`): the tensor cores. One CTA per
// (128-query tile, head, batch row), the heaviest causal tiles first (the
// tile index varies slowest over the grid), of two consumer warpgroups
// that own 64 query rows each and one producer warp. The producer's one
// thread copies the Q tile once and each 64-key tile of K and V by TMA,
// from the strided (B, S, H, D) tensors through tensor maps built on the
// host per call, into a ring of three stages with the hardware's 128-byte
// swizzle where it divides a row, else 64-byte where that does (head dims
// 32 and 96: boxes of 32 columns, three side by side at 96; at 192 three
// 128-byte boxes of 64 columns), else 128-byte
// over a tile wider than the row (head dim 112: two boxes of 64 columns,
// of which TMA fills columns 112 to 127 with zeros, out of the tensor's
// range, and counts them in the bytes it delivers); V has a tile of its
// own width; rows past S arrive as zeros. A stage's
// `full` mbarrier counts the bytes of its copies, its `empty` mbarrier the
// 256 consumer threads done with it; the producer refills a stage as soon
// as it is empty, so copies run up to three tiles ahead of the products
// and the two warpgroups drift apart freely. Per tile and warpgroup: S =
// Q K^T by D / 16 wgmma (m64n64k16, both operands K-major in shared
// memory); the online softmax in registers on the accumulator's fragment
// (a row's max reduced over the 4 lanes that share it, exp2 on the
// special-function unit with the scale folded into one FMA, the sum kept
// per thread and reduced once at the end); P rounded to bf16 in the
// registers that held S, which is the A operand of O += P V by 4
// register-A wgmma (m64nNk16 over the V tile's N columns, V MN-major in
// shared memory: at 112 the products of 128, whose last 16 columns of V
// are zeros and of O are never written). The products
// of one tile overlap the softmax of the next: S of tile t is started
// before P V of tile t - 1, and the softmax of tile t runs while P V of
// tile t - 1 is on the tensor cores. O stays in float32 registers and is
// divided and rounded once. Tiles that cross the diagonal, the window edge
// or Skv are masked (to -inf); a warpgroup skips the tiles that none of
// its rows sees. P is rounded to bf16 for P V, as FlashAttention-2/3 and
// SDPA round it; the Pallas kernel keeps it in float32. A row that sees no
// key at all gives 0 (the Pallas kernel: the mean of the values it
// covered); no caller asks for one. Shared memory at D = 128: Q 32 KB + 3
// x (K 16 KB + V 16 KB), one CTA per SM (about 160 registers a thread),
// and the same at 112; at (96, 64): Q 24 KB + 3 x (K 12 KB + V 8 KB); at
// (192, 128): Q 48 KB + 3 x (K 24 KB + V 16 KB), 169 KB in all.
//
// float32 (`flash_attention_kernel`): the CUDA cores, unchanged since its
// first version. TF32 or bf16 products cannot meet the reference's float32
// tolerance (2e-5), so this instance stays in float32 FMAs: one CTA of 128
// threads per (64-query tile, head, batch row); the query tile and each
// 32-key tile of K and V staged in shared memory as float32 (rows padded
// by one float against bank conflicts); each thread owns a 4 x 4 block of
// the score tile and 4 rows x Dv/8 columns of the accumulator; a row's max
// and sum are reduced over its 8 threads with warp shuffles.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../hopper.cuh"
#include "../tiles.cuh"

namespace {

using tiles::from_f32;
using tiles::load_rows;

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

// Element strides of the batch, sequence and head axes of a (B, S, H, D)
// tensor; the head_dim axis has stride 1.
struct Strides {
  int64_t b, s, h;
};

// ---- float32: CUDA cores ----------------------------------------------------

constexpr int kThreads = 128;      // 16 row groups x 8 column lanes
constexpr int kBQ = 64;            // query rows per CTA (16 x 4)
constexpr int kBK = 32;            // keys per tile (8 x 4)

template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (DQK + 1) + kBK * (DQK + 1) +
          kBK * (DV + 1) + kBQ * (kBK + 1));
}

// DQK: the head dim of q and k; DV: that of v and o.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           int n_heads, int n_kv_heads, int q_len,
                           int kv_len, int q_offset, int causal, int window,
                           float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // kBQ x (DQK + 1)
  float* ks = qs + kBQ * (DQK + 1);    // kBK x (DQK + 1)
  float* vs = ks + kBK * (DQK + 1);    // kBK x (DV + 1)
  float* ps = vs + kBK * (DV + 1);     // kBQ x (kBK + 1): probabilities

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h * n_kv_heads / n_heads;
  const int ty = threadIdx.x / 8;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = threadIdx.x % 8;  // score columns tx + 8j, acc columns
                                   // tx + 8c

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  const int q_rows = min(kBQ, q_len - q0);
  load_rows<T, DQK>(qs, qb + q0 * sq.s, sq.s, kBQ, q_rows);

  // the keys some row of this tile may see: [k_begin, k_end)
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q0 + q_rows - 1 + q_offset + 1);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  constexpr int kCols = DV / 8;
  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    const int valid = min(kBK, kv_len - k0);
    load_rows<T, DQK>(ks, kb + k0 * sk.s, sk.s, kBK, valid);
    load_rows<T, DV>(vs, vb + k0 * sv.s, sv.s, kBK, valid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < DQK; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * (DQK + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 8 * j) * (DQK + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 8 * j;
        bool ok = kp < kv_len;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 8 threads are lanes that differ in their low 3 bits
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * (kBK + 1) + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[j * (DV + 1) + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row < q_rows) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = ob + (q0 + row) * so.s;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        orow[tx + 8 * c] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* o, const int64_t* st, int batch, int n_heads,
                         int n_kv_heads, int q_len, int kv_len, int q_offset,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DQK, DV>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((q_len + kBQ - 1) / kBQ, n_heads, batch);
  flash_attention_kernel<T, DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, n_heads,
      n_kv_heads, q_len, kv_len, q_offset, causal, window, scale);
  return cudaGetLastError();
}

// The (q/k, v) head dims of the instances: (32, 32), (64, 64), (128,
// 128), MLA's (96, 64) (MiniCPM3: qk_nope 64 + qk_rope 32, v 64) and (192,
// 128) (DeepSeek-V2-Lite: qk_nope 128 + qk_rope 64, v 128), and Zamba2's
// (112, 112).
template <typename T>
cudaError_t launch_dim(int head_dim, int v_head_dim, const void* q,
                       const void* k, const void* v, void* o,
                       const int64_t* st, int batch, int n_heads,
                       int n_kv_heads, int q_len, int kv_len, int q_offset,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
#define FA_CASE(DQK, DV)                                                    \
  if (head_dim == DQK && v_head_dim == DV)                                 \
    return launch_typed<T, DQK, DV>(q, k, v, o, st, batch, n_heads,       \
                                    n_kv_heads, q_len, kv_len, q_offset,  \
                                    causal, window, scale, stream);
  FA_CASE(32, 32)
  FA_CASE(64, 64)
  FA_CASE(128, 128)
  FA_CASE(96, 64)
  FA_CASE(192, 128)
  FA_CASE(112, 112)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

// ---- bfloat16: tensor cores -------------------------------------------------

constexpr int kConsumers = 256;  // two warpgroups
constexpr int kTcThreads = kConsumers + 32;  // and one producer warp
constexpr int kTcBQ = 128;       // query rows per CTA, 64 per warpgroup
constexpr int kTcBK = 64;        // keys per tile
constexpr int kStages = 3;       // K / V ring

// The shared-memory layout of a tile whose rows are D bf16 values: boxes
// of kBoxCols columns (one swizzle row of kSwizzle bytes) by the tile's
// rows, kBoxes boxes side by side, kCols columns in all. The swizzle row is
// 128 bytes where it divides the row, the whole row where that is shorter,
// else 64 where that divides it (D = 32 and D = 96: 2 and 3 boxes of 32),
// else 128 over kCols > D columns (D = 112: two boxes of 64, the last
// holding 48 columns of the tensor and 16 that TMA fills with zeros).
template <int D>
struct TcRows {
  static constexpr int kSwizzle =
      D * 2 % 128 == 0 ? 128
                       : (D * 2 < 128 ? D * 2 : (D * 2 % 64 == 0 ? 64 : 128));
  static constexpr int kBoxCols = kSwizzle / 2;
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kCols = kBoxes * kBoxCols;
  static constexpr int kAtom = 8 * kSwizzle;       // 8 swizzled rows
  static_assert(D % 16 == 0 && kCols - D < kBoxCols,
                "D is a multiple of a product's 16 and fills its last box "
                "in part at most");
};

// Shared-memory geometry of one CTA: Q and K tiles of DQK columns, V tiles
// of DV columns, each laid out as TcRows of its own width.
template <int DQK, int DV>
struct TcTile {
  using QK = TcRows<DQK>;
  using V = TcRows<DV>;
  static constexpr int kQBox = kTcBQ * QK::kSwizzle;   // bytes
  static constexpr int kKBox = kTcBK * QK::kSwizzle;
  static constexpr int kVBox = kTcBK * V::kSwizzle;
  static constexpr int kQBytes = kQBox * QK::kBoxes;
  static constexpr int kKBytes = kKBox * QK::kBoxes;
  static constexpr int kVBytes = kVBox * V::kBoxes;
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0 &&
                    kVBytes % 1024 == 0,
                "every tile starts on a swizzle atom");
  // 1,024 for aligning the tiles to a swizzle atom; 64 for the barriers
  static constexpr size_t kSmem =
      1024 + kQBytes + kStages * (kKBytes + kVBytes) + 64;
};

// O (m64nN) += P (64 x 16 keys, bf16 in registers) * V (16 keys x N), N
// the V tile's columns (TcRows::kCols).
template <int N>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* p,
                                        uint64_t v_desc);
template <>
__device__ __forceinline__ void pv_step<32>(float* o, const uint32_t* p,
                                            uint64_t v_desc) {
  hopper::wgmma_rs_m64n32k16(o, p, v_desc, 1);
}
template <>
__device__ __forceinline__ void pv_step<64>(float* o, const uint32_t* p,
                                            uint64_t v_desc) {
  hopper::wgmma_rs_m64n64k16(o, p, v_desc, 1);
}
template <>
__device__ __forceinline__ void pv_step<128>(float* o, const uint32_t* p,
                                             uint64_t v_desc) {
  hopper::wgmma_rs_m64n128k16(o, p, v_desc, 1);
}

// Starts (and commits, without waiting) S = Q K^T for warpgroup `wg`'s 64
// rows against the key tile `k_tile`: DQK / 16 products, K-major operands
// (at 112 the tile's zero columns 112 to 127 take no product).
template <int DQK, int DV>
__device__ __forceinline__ void qk_mma(float (&sc)[kTcBK / 2],
                                       const uint8_t* qs,
                                       const uint8_t* k_tile, int wg) {
  using G = TcTile<DQK, DV>;
  using R = typename G::QK;
  hopper::fence_operands(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const int x = kk * 16 / R::kBoxCols;
    const int within = (kk * 16 % R::kBoxCols) * 2;
    const uint64_t a = hopper::make_desc(
        qs + x * G::kQBox + wg * 64 * R::kSwizzle + within, 16, R::kAtom,
        R::kSwizzle);
    const uint64_t b = hopper::make_desc(k_tile + x * G::kKBox + within, 16,
                                         R::kAtom, R::kSwizzle);
    hopper::wgmma_ss_m64n64k16(sc, a, b, kk > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_operands(sc);
}

// Starts (and commits, without waiting) O += P V for the value tile
// `v_tile`: kTcBK / 16 products, P from registers, V MN-major, O over the
// tile's kCols columns.
template <int DQK, int DV>
__device__ __forceinline__ void pv_mma(
    float (&o)[TcTile<DQK, DV>::V::kCols / 2],
                                       const uint32_t (&pa)[kTcBK / 16][4],
                                       const uint8_t* v_tile) {
  using G = TcTile<DQK, DV>;
  using R = typename G::V;
  hopper::fence_operands(o);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk)
    pv_step<R::kCols>(o, pa[kk],
                hopper::make_desc(v_tile + kk * 16 * R::kSwizzle, G::kVBox,
                                  R::kAtom, R::kSwizzle));
  hopper::wgmma_commit();
  hopper::fence_operands(o);
}

// The online softmax of one tile's raw scores q . k, in place on the
// accumulator's fragment (rows i = 0, 1 of this thread: positions qp0 +
// 8 i): masks them where `edge` (to -inf, which the running max, finite
// from its start at -1e30, turns into p = 0), updates the running max m (in
// log2 units: scores times scale * log2(e)) and this thread's share l of
// the running sum, turns the scores into probabilities 2^(s * scale_log2 -
// m) (one FMA and one exp2 each) and returns each row's rescale factor in
// alpha.
__device__ __forceinline__ void softmax_tile(float (&sc)[kTcBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int k0, int qp0, int col0,
                                             int kv_len, int causal,
                                             int window, float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kTcBK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = sc[4 * j + 2 * i + c];
        if (edge) {
          const int kp = k0 + 8 * j + col0 + c;
          const int qp = qp0 + 8 * i;
          bool ok = kp < kv_len;
          if (causal) ok = ok && kp <= qp;
          if (window) ok = ok && kp > qp - window;
          v = ok ? v : -INFINITY;
          sc[4 * j + 2 * i + c] = v;
        }
        mx[i] = fmaxf(mx[i], v);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the row's 4 threads are lanes that differ in their low 2 bits
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);
    alpha[i] = hopper::exp2_approx(m[i] - m_new);
    m[i] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kTcBK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = hopper::exp2_approx(
            fmaf(sc[4 * j + 2 * i + c], scale_log2, -m[i]));
        sc[4 * j + 2 * i + c] = p;
        sum[i] += p;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// P as the A operand of P V: bf16 pairs, 16 keys (4 registers) per product.
__device__ __forceinline__ void pack_p(const float (&sc)[kTcBK / 2],
                                       uint32_t (&pa)[kTcBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] =
          hopper::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// Thread 0: the TMA copies of key tile t (K and V) into its ring stage.
template <int DQK, int DV>
__device__ __forceinline__ void load_kv_tile(uint8_t* ks, uint8_t* vs,
                                             uint64_t* full,
                                             const CUtensorMap* tk,
                                             const CUtensorMap* tv, int t,
                                             int k_begin, int hk, int b) {
  using G = TcTile<DQK, DV>;
  const int s = t % kStages;
  const int k0 = k_begin + t * kTcBK;
  hopper::mbar_arrive_expect_tx(&full[s], G::kKBytes + G::kVBytes);
#pragma unroll
  for (int x = 0; x < G::QK::kBoxes; ++x)
    hopper::tma_load_4d(ks + s * G::kKBytes + x * G::kKBox, tk, &full[s],
                        x * G::QK::kBoxCols, hk, k0, b);
#pragma unroll
  for (int x = 0; x < G::V::kBoxes; ++x)
    hopper::tma_load_4d(vs + s * G::kVBytes + x * G::kVBox, tv, &full[s],
                        x * G::V::kBoxCols, hk, k0, b);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kTcThreads)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ o, Strides so,
                              int n_heads, int n_kv_heads, int q_len,
                              int kv_len, int q_offset, int causal,
                              int window, float scale_log2) {
  using G = TcTile<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) &
                            1023);
  uint8_t* ks = qs + G::kQBytes;                 // kStages x (K tile)
  uint8_t* vs = ks + kStages * G::kKBytes;       // kStages x (V tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * G::kVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const int b = blockIdx.z;
  const int hk = h * n_kv_heads / n_heads;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  // the keys some row of this tile may see: [k_begin, k_end)
  const int q_rows = min(kTcBQ, q_len - q0);
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q0 + q_rows + q_offset);
  int k_begin = window ? max(0, q0 + q_offset - window + 1) : 0;
  k_begin = (k_begin / kTcBK) * kTcBK;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kTcBK - 1) / kTcBK : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_init(q_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: one thread starts every copy
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(q_full, G::kQBytes);
#pragma unroll
      for (int x = 0; x < G::QK::kBoxes; ++x)
        hopper::tma_load_4d(qs + x * G::kQBox, &tq, q_full,
                            x * G::QK::kBoxCols, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= kStages)  // the consumers are done with tile t - kStages
          hopper::mbar_wait(&empty[t % kStages], (t / kStages - 1) & 1);
        load_kv_tile<DQK, DV>(ks, vs, full, &tk, &tv, t, k_begin, hk, b);
      }
    }
    return;
  }

  // this thread's rows of the tile (i = 0, 1: row0 + 8 i) and its first
  // column of each 8-column block; this warpgroup's rows as positions
  const int row0 = wg * 64 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const bool has_rows = q0 + wg * 64 < q_len;
  const int p_first = q0 + wg * 64 + q_offset;
  const int p_last = min(q0 + wg * 64 + 63, q_len - 1) + q_offset;

  constexpr int kS = kTcBK / 2;  // score registers per thread
  constexpr int kVCols = G::V::kCols;  // O's columns in the products
  float acc[kVCols / 2];
#pragma unroll
  for (int i = 0; i < kVCols / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  // this warpgroup's tiles [t_begin, t_end): the band of key tiles that
  // some of its rows see (the tiles outside are wholly masked)
  auto seen = [&](int t) {
    const int k0 = k_begin + t * kTcBK;
    return has_rows && k0 < kv_len && !(causal && k0 > p_last) &&
           !(window && k0 + kTcBK - 1 <= p_first - window);
  };
  int t_begin = 0, t_end = n_tiles;
  while (t_begin < t_end && !seen(t_begin)) ++t_begin;
  while (t_end > t_begin && !seen(t_end - 1)) --t_end;
  // a tile crossing the diagonal, the window edge or kv_len is masked
  auto edge = [&](int t) {
    const int k0 = k_begin + t * kTcBK;
    return k0 + kTcBK > kv_len || (causal && k0 + kTcBK - 1 > p_first) ||
           (window && k0 <= p_last - window);
  };

  hopper::mbar_wait(q_full, 0);
  // every tile's stage is released in order, seen or not
  for (int t = 0; t < t_begin; ++t) {
    hopper::mbar_wait(&full[t % kStages], (t / kStages) & 1);
    hopper::mbar_arrive(&empty[t % kStages]);
  }
  if (t_begin < t_end) {
    // S of tile t overlaps P V of tile t - 1 on the tensor cores: the
    // scores of the next tile are started before the products of this one,
    // and its softmax runs while those products do
    float sc[kS];
    uint32_t pa[kTcBK / 16][4];
    float alpha[2];
    hopper::mbar_wait(&full[t_begin % kStages], (t_begin / kStages) & 1);
    qk_mma<DQK, DV>(sc, qs, ks + (t_begin % kStages) * G::kKBytes, wg);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);
    softmax_tile(sc, m, l, alpha, edge(t_begin),
                 k_begin + t_begin * kTcBK, q0 + row0 + q_offset, col0,
                 kv_len, causal, window, scale_log2);
    pack_p(sc, pa);
    for (int t = t_begin + 1; t < t_end; ++t) {
      const int s = t % kStages;
      const int prev = (t - 1) % kStages;
      hopper::mbar_wait(&full[s], (t / kStages) & 1);
      qk_mma<DQK, DV>(sc, qs, ks + s * G::kKBytes, wg);
      pv_mma<DQK, DV>(acc, pa, vs + prev * G::kVBytes);
      hopper::wgmma_wait<1>();  // the scores of tile t
      hopper::fence_operands(sc);
      softmax_tile(sc, m, l, alpha, edge(t), k_begin + t * kTcBK,
                   q0 + row0 + q_offset, col0, kv_len, causal, window,
                   scale_log2);
      hopper::wgmma_wait<0>();  // P V of tile t - 1
      hopper::fence_operands(acc);
      hopper::mbar_arrive(&empty[prev]);
#pragma unroll
      for (int j = 0; j < kVCols / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * j + 2 * i] *= alpha[i];
          acc[4 * j + 2 * i + 1] *= alpha[i];
        }
      pack_p(sc, pa);
    }
    pv_mma<DQK, DV>(acc, pa, vs + ((t_end - 1) % kStages) * G::kVBytes);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    hopper::mbar_arrive(&empty[(t_end - 1) % kStages]);
  }
  for (int t = t_end; t < n_tiles; ++t) {
    hopper::mbar_wait(&full[t % kStages], (t / kStages) & 1);
    hopper::mbar_arrive(&empty[t % kStages]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row < q_rows) {
      const float inv = 1.0f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = o + b * so.b + h * so.h + (q0 + row) * so.s;
      // the tensor's DV columns only: at 112 the next head's follow
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
            hopper::pack_bf16(acc[4 * j + 2 * i] * inv,
                              acc[4 * j + 2 * i + 1] * inv);
    }
  }
}

// `geometry`: the tensor maps of q, k and v, 11 values each (dims, byte
// strides, box; see hopper::encode_bf16_4d), as the wrapper builds them.
template <int DQK, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const int64_t* st, const int64_t* geometry, int batch,
                      int n_heads, int n_kv_heads, int q_len, int kv_len,
                      int q_offset, int causal, int window, float scale,
                      cudaStream_t stream) {
  using G = TcTile<DQK, DV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tc_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (attr != cudaSuccess) return attr;
  // per tensor (q, k, v): head dim, box columns, box rows
  const int want[3][3] = {{DQK, G::QK::kBoxCols, kTcBQ},
                          {DQK, G::QK::kBoxCols, kTcBK},
                          {DV, G::V::kBoxCols, kTcBK}};
  for (int i = 0; i < 3; ++i)
    if (geometry[11 * i] != want[i][0] || geometry[11 * i + 7] != want[i][1] ||
        geometry[11 * i + 9] != want[i][2])
      return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!hopper::encode_bf16_4d(&tq, q, geometry) ||
      !hopper::encode_bf16_4d(&tk, k, geometry + 11) ||
      !hopper::encode_bf16_4d(&tv, v, geometry + 22))
    return cudaErrorInvalidValue;
  const Strides so{st[9], st[10], st[11]};
  const dim3 grid(n_heads, (q_len + kTcBQ - 1) / kTcBQ, batch);
  flash_attention_tc_kernel<DQK, DV><<<grid, kTcThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so, n_heads, n_kv_heads,
      q_len, kv_len, q_offset, causal, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t launch_tc_dim(int head_dim, int v_head_dim, const void* q,
                          const void* k, const void* v, void* o,
                          const int64_t* st, const int64_t* geometry,
                          int batch, int n_heads, int n_kv_heads, int q_len,
                          int kv_len, int q_offset, int causal, int window,
                          float scale, cudaStream_t stream) {
#define FA_TC_CASE(DQK, DV)                                                 \
  if (head_dim == DQK && v_head_dim == DV)                                 \
    return launch_tc<DQK, DV>(q, k, v, o, st, geometry, batch, n_heads,   \
                              n_kv_heads, q_len, kv_len, q_offset, causal, \
                              window, scale, stream);
  FA_TC_CASE(32, 32)
  FA_TC_CASE(64, 64)
  FA_TC_CASE(128, 128)
  FA_TC_CASE(96, 64)
  FA_TC_CASE(192, 128)
  FA_TC_CASE(112, 112)
#undef FA_TC_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv), o (B, Sq, H,
// Dv), with (D, Dv) = (head_dim, v_head_dim) one of the instances of
// launch_dim, all of one dtype (0: float32, 1: bfloat16), read and
// written through the 12 element
// strides in `strides` (batch, sequence, head of q, k, v, o in turn).
// bfloat16 also takes `geometry`: the TMA tensor maps of q, k and v (11
// values each: dims, byte strides, box), built by the wrapper; float32
// ignores it. Launches on `stream` and returns a CUDA error code: 0 when
// the launch was accepted. The caller checks shapes, types, devices and
// alignment.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* strides,
                                      const int64_t* geometry, int batch,
                                      int n_heads, int n_kv_heads, int q_len,
                                      int kv_len, int head_dim,
                                      int v_head_dim, int dtype,
                                      int q_offset, int causal, int window,
                                      float scale, void* stream) {
  if (batch <= 0 || q_len <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dim<float>(head_dim, v_head_dim, q, k, v, o, strides, batch,
                            n_heads, n_kv_heads, q_len, kv_len, q_offset,
                            causal, window, scale, s);
  else if (dtype == 1 && geometry != nullptr)
    err = launch_tc_dim(head_dim, v_head_dim, q, k, v, o, strides, geometry,
                        batch, n_heads, n_kv_heads, q_len, kv_len, q_offset,
                        causal, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
