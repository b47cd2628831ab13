// Single-token decode attention against a KV cache for Hopper (sm_90a),
// split-KV (flash-decoding) in one launch.
//
// Replaces the Pallas TPU kernel `decode_attention`
// (src/repro/kernels/decode_attention/decode_attention.py, `_kernel`): one
// query token per sequence attends to its cache rows k with
//
//   k < pos[b]  and  (!window or k >= pos[b] - window),
//
// where pos[b] is the sequence's valid length, read on the device. The G =
// H / Hkv query heads of a group share one cache head. The online softmax
// keeps m, l and the accumulator in float32.
//
// Bound: bytes. Each visible cache row is read once for K and once for V
// (2 * Hkv * D elements per position) against 4 * H * D operations per
// position: a few operations per byte, far below the H100's 295. At the
// serving shape (4 sequences, 32 heads over 8, a 1,536-row cache, pos
// drawn in [1, 1536], bf16) that is 6.8 MB: 2.044 us at 3.35 TB/s. The
// work per call is tiny, so what the design fights is latency. Instances:
// q/k head dim D and v head dim Dv of (32, 32), (64, 64), (128, 128),
// MLA's (96, 64) and Zamba2's (112, 112): each lane holds ceil(D / 32)
// elements of q and k rows and ceil(Dv / 32) of v rows and of the
// accumulator; at 112, 4 each in lanes 0 to 27, and lanes 28 to 31 hold
// none (zeros in q, no load, no store). MLA's 40 heads over 40 cache heads
// and Zamba2's 32 over 32 (a group of 1) run in the kG = 4 instance, three
// of its four head lanes idle.
//
// Design: the Pallas kernel walks the cache of one sequence in one grid
// row; at batch 4 that would be 4 CTAs on 132 SMs. Here the grid is
// (n_split, Hkv, B): the visible range [lo, hi) of a sequence is cut into
// n_split equal slices, computed on the device from pos, so only rows that
// hold visible positions are read and no CTA waits on a host copy of pos.
// A CTA of 4 warps streams its slice in tiles of 32 keys through a ring of
// 4 stages in shared memory, by 16-byte cp.async copies in the cache's own
// dtype (rows past the slice are zero-filled), so the copies of the next
// three tiles run under the current tile's math (a row of 112 bf16 values
// is 14 copies of 16 bytes). Warps take keys (8 of each tile), lanes split
// D: each lane holds ceil(D / 32) elements of q for all
// G heads of the group in registers, pre-scaled by scale * log2(e). A
// step scores 32 (key, head) pairs (8 keys at G <= 4, 4 at G <= 8, 2 at
// G <= 16): each
// lane forms its partial dot of every pair, and one transposing butterfly
// (`transpose_sum`, 31 shuffles) leaves the full score of pair `lane` in
// that lane, which then takes one exp2 for its pair; the probabilities are
// broadcast back by shuffles for P V, which each warp accumulates with
// lanes over D, keeping its own (m, l, acc) per head. The 4 warps merge
// through shared memory once per slice.
//
// The merge of the slices happens in the same launch: each CTA
// writes its float32 partials (acc, m, l) to a workspace, fences, and takes
// a ticket from the (b, hk) counter with atomicAdd; the CTA that draws the
// last ticket merges
//
//   M = max m_i,  l = sum l_i 2^(m_i - M),  o = sum acc_i 2^(m_i - M) / l,
//
// dividing by max(l, 1e-30) as the Pallas kernel does, and resets the
// counter to 0, so the counters need zeroing only once, when the wrapper
// makes them, and a CUDA graph may replay the launch. A slice with no
// visible key leaves (m, l, acc) = (-1e30, 0, 0), which the merge weighs by
// zero. A sequence with no visible key at all (pos = 0) gives 0 here,
// where the Pallas kernel gives the mean of the whole cache; the model
// never asks for that row (it attends with pos + 1 >= 1).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../hopper.cuh"
#include "../tiles.cuh"

namespace {

using tiles::from_f32;

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;            // keys per tile
constexpr int kWarpKeys = kBK / kWarps;
constexpr int kStages = 4;         // tiles in the ring
constexpr int kMaxGroups = 16;     // query heads per cache head
constexpr int kMaxSplits = 64;     // slices per (sequence, cache head)

// Element strides: q and o (B, H, D) by batch and head; the caches
// (B, S, Hkv, D) by batch, position and head. The head_dim axis has
// stride 1.
struct Strides {
  int64_t q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h;
};

// Shared memory: the ring of K and V tiles; after the walk, the same bytes
// hold each warp's (m, l, acc) per head for the merge.
template <typename T, int DQK, int DV, int kG>
constexpr size_t smem_bytes() {
  constexpr size_t ring = sizeof(T) * kStages * kBK * (DQK + DV);
  constexpr size_t warps = sizeof(float) * kWarps * kG * (DV + 2);
  constexpr size_t splits = sizeof(float) * 2 * kMaxSplits * kG;
  constexpr size_t most = ring > warps ? ring : warps;
  return most > splits ? most : splits;
}

// E consecutive elements at p (aligned to E elements) as float.
template <int E>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (E == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x;
    out[1] = a.y;
    out[2] = a.z;
    out[3] = a.w;
  } else if constexpr (E == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x;
    out[1] = a.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = p[e];
  }
}
template <int E>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (E == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(v[0]);
    const float2 b = __bfloat1622float2(v[1]);
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else if constexpr (E == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x;
    out[1] = a.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = __bfloat162float(p[e]);
  }
}

// All threads: the cp.async copies of key tile t of the slice [s_lo, s_hi)
// into its ring stage (kBK rows of K, DQK wide, then kBK rows of V, DV
// wide), rows past s_hi zero-filled.
template <typename T, int DQK, int DV>
__device__ __forceinline__ void load_tile(T* ring, const T* kb,
                                           const T* vb, int64_t k_s,
                                           int64_t v_s, int t, int s_lo,
                                           int s_hi) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksK = DQK / kVec;  // 16-byte chunks per row
  constexpr int kChunksV = DV / kVec;
  const int k0 = s_lo + t * kBK;
  const int valid = min(kBK, s_hi - k0);
  T* kd = ring + (t % kStages) * kBK * (DQK + DV);
  T* vd = kd + kBK * DQK;
  for (int idx = threadIdx.x; idx < kBK * (kChunksK + kChunksV);
       idx += kThreads) {
    const bool is_v = idx >= kBK * kChunksK;
    const int chunks = is_v ? kChunksV : kChunksK;
    const int rem = is_v ? idx - kBK * kChunksK : idx;
    const int r = rem / chunks;
    const int c = (rem % chunks) * kVec;
    const T* base = is_v ? vb : kb;
    const T* src = r < valid ? base + (k0 + r) * (is_v ? v_s : k_s) + c
                             : base;
    hopper::cp_async16((is_v ? vd + r * DV : kd + r * DQK) + c, src,
                       r < valid ? 16 : 0);
  }
}

// Sums each of the 32 values v[n] of every lane over the 32 lanes of the
// warp and leaves the sum of v[lane] in lane `lane`: at each of 5 steps a
// lane keeps half of its values, swaps the other half with the lane that
// keeps it, and adds, so 31 shuffles do the work of 32 reductions.
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int bit = 16 >> step;
    const int half = 16 >> step;  // values left: 2 * half
    const bool upper = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = upper ? v[i + half] : v[i];
      const float send = upper ? v[i] : v[i + half];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
  return v[0];
}

// DQK: the head dim of q and k; DV: that of v and o. kG: query heads per
// cache head that the registers hold (>= H / Hkv).
template <typename T, int DQK, int DV, int kG>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ pos,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_m,
                            float* __restrict__ part_l,
                            int* __restrict__ counters, T* __restrict__ o,
                            Strides st, int n_heads, int n_kv_heads,
                            int max_len, int window, int n_split,
                            float scale_log2) {
  // elements of a q or k row, and of a v or o row, per lane; lanes past
  // the row (at 112: lanes 28 to 31) hold none
  constexpr int E = (DQK + 31) / 32;
  constexpr int EV = (DV + 31) / 32;
  static_assert(DQK % E == 0 && DV % EV == 0,
                "a lane holds a whole share of the row or none");
  // keys scored at once: one (key, head) score per lane
  constexpr int kSub = 32 / kG;
  static_assert(kSub * kG == 32 && kWarpKeys % kSub == 0,
                "a step scores 32 (key, head) pairs");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int groups = n_heads / n_kv_heads;
  const bool k_lane = lane * E < DQK;    // this lane holds q and k elements
  const bool v_lane = lane * EV < DV;    // and v and o elements

  // this CTA's slice [s_lo, s_hi) of the visible range [lo, hi)
  const int p = pos[b];
  const int hi = min(p, max_len);
  const int lo = window > 0 ? max(0, p - window) : 0;
  const int len = max(hi - lo, 0);
  const int s_lo = lo + static_cast<int>(static_cast<int64_t>(len) * split /
                                         n_split);
  const int s_hi = lo + static_cast<int>(static_cast<int64_t>(len) *
                                         (split + 1) / n_split);
  const int n_tiles = (s_hi - s_lo + kBK - 1) / kBK;

  const T* kb = k + b * st.k_b + hk * st.k_h;
  const T* vb = v + b * st.v_b + hk * st.v_h;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      load_tile<T, DQK, DV>(ring, kb, vb, st.k_s, st.v_s, t, s_lo, s_hi);
    hopper::cp_async_commit();
  }

  float qr[kG][E];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < groups && k_lane) {
      load_vec<E>(q + b * st.q_b + (hk * groups + g) * st.q_h + lane * E,
                  qr[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] *= scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.0f;
    }
  }
  // the running max and sum of head `lane % kG` (the same in every lane of
  // that head), and the accumulator of every head over this lane's columns
  float m = kNegInf, l = 0.0f, acc[kG][EV];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[g][e] = 0.0f;
  // after transpose_sum this lane holds the score of key lane / kG of the
  // step, head lane % kG
  const int lane_key = lane / kG;

  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; tile t - 1's readers are done
    if (t + kStages - 1 < n_tiles)
      load_tile<T, DQK, DV>(ring, kb, vb, st.k_s, st.v_s, t + kStages - 1,
                            s_lo, s_hi);
    hopper::cp_async_commit();

    const T* kd = ring + (t % kStages) * kBK * (DQK + DV);
    const T* vd = kd + kBK * DQK;
#pragma unroll
    for (int j0 = 0; j0 < kWarpKeys; j0 += kSub) {
      const int r0 = warp * kWarpKeys + j0;  // first key of the step
      float v[32];                           // v[j * kG + g]: partial dots
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        float kv[E] = {};
        if (k_lane) load_vec<E>(kd + (r0 + j) * DQK + lane * E, kv);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float x = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e) x += qr[g][e] * kv[e];
          v[j * kG + g] = x;
        }
      }
      const float dot = transpose_sum(v, lane);  // every lane shuffles
      const bool ok = s_lo + t * kBK + r0 + lane_key < s_hi;
      const float sc = ok ? dot : kNegInf;
      float mx = sc;
#pragma unroll
      for (int off = kG; off < 32; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f(m - m_new);
      const float p = ok ? exp2f(sc - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int off = kG; off < 32; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m = m_new;
      l = l * alpha + sum;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float a = __shfl_sync(0xffffffffu, alpha, g);
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[g][e] *= a;
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        float vv[EV] = {};
        if (v_lane) load_vec<EV>(vd + (r0 + j) * DV + lane * EV, vv);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float pj = __shfl_sync(0xffffffffu, p, j * kG + g);
#pragma unroll
          for (int e = 0; e < EV; ++e) acc[g][e] += pj * vv[e];
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it now holds the warps' partials

  float* wm = reinterpret_cast<float*>(smem_raw);  // kWarps x kG
  float* wl = wm + kWarps * kG;                    // kWarps x kG
  float* wacc = wl + kWarps * kG;                  // kWarps x kG x DV
  if (lane < groups) {
    wm[warp * kG + lane] = m;
    wl[warp * kG + lane] = l;
  }
#pragma unroll
  for (int g = 0; g < kG; ++g)
    if (g < groups && v_lane)
#pragma unroll
      for (int e = 0; e < EV; ++e)
        wacc[(warp * kG + g) * DV + lane * EV + e] = acc[g][e];
  __syncthreads();

  // this CTA's partials: the 4 warps merged
  const int64_t slot =
      (static_cast<int64_t>(b) * n_kv_heads + hk) * n_split + split;
  for (int idx = tid; idx < groups * DV; idx += kThreads) {
    const int g = idx / DV;
    const int d = idx % DV;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * kG + g]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * kG + g] - mm);
      ll += wl[w * kG + g] * f;
      aa += wacc[(w * kG + g) * DV + d] * f;
    }
    part_acc[(slot * groups + g) * DV + d] = aa;
    if (d == 0) {
      part_m[slot * groups + g] = mm;
      part_l[slot * groups + g] = ll;
    }
  }

  // the last CTA of this (b, hk) to finish merges the n_split partials
  __shared__ int ticket;
  __threadfence();
  __syncthreads();
  int* counter = counters + b * n_kv_heads + hk;
  if (tid == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (ticket != n_split - 1) return;
  __threadfence();
  // every slice's (m, l) into shared memory, then per head the weight of
  // each slice, 2^(m_i - M) / max(l, 1e-30), then the weighted sum
  const int64_t base = (static_cast<int64_t>(b) * n_kv_heads + hk) * n_split;
  const int n_parts = n_split * groups;
  float* sm = reinterpret_cast<float*>(smem_raw);  // n_split x groups
  float* sl = sm + n_parts;                        // n_split x groups
  for (int i = tid; i < n_parts; i += kThreads) {
    sm[i] = __ldcg(part_m + base * groups + i);
    sl[i] = __ldcg(part_l + base * groups + i);
  }
  __syncthreads();
  if (tid < groups) {
    float mm = kNegInf;
    for (int sp = 0; sp < n_split; ++sp)
      mm = fmaxf(mm, sm[sp * groups + tid]);
    float ll = 0.0f;
    for (int sp = 0; sp < n_split; ++sp)
      ll += sl[sp * groups + tid] * exp2f(sm[sp * groups + tid] - mm);
    const float inv = 1.0f / fmaxf(ll, 1e-30f);
    for (int sp = 0; sp < n_split; ++sp)
      sm[sp * groups + tid] = exp2f(sm[sp * groups + tid] - mm) * inv;
  }
  __syncthreads();
  // every load of a batch of 4 slices in flight at once
  constexpr int kPer = (kG * DV + kThreads - 1) / kThreads;
  float aa[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) aa[i] = 0.0f;
#pragma unroll 4
  for (int sp = 0; sp < n_split; ++sp) {
    const float* src = part_acc + (base + sp) * groups * DV;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < groups * DV)
        aa[i] += __ldcg(src + idx) * sm[sp * groups + idx / DV];
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < groups * DV)
      o[b * st.o_b + (hk * groups + idx / DV) * st.o_h + idx % DV] =
          from_f32<T>(aa[i]);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

// The launch arguments after the tensors, passed down unchanged.
struct Shape {
  int batch, n_heads, n_kv_heads, max_len, window, n_split;
  float scale;
};

struct Buffers {
  const void *q, *k, *v;
  const int* pos;
  float *part_acc, *part_m, *part_l;
  int* counters;
  void* o;
};

template <typename T, int DQK, int DV, int kG>
cudaError_t launch_typed(const Buffers& x, const Strides& st,
                         const Shape& sh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DQK, DV, kG>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, DQK, DV, kG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(sh.n_split, sh.n_kv_heads, sh.batch);
  decode_attention_kernel<T, DQK, DV, kG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.k),
      static_cast<const T*>(x.v), x.pos, x.part_acc, x.part_m, x.part_l,
      x.counters, static_cast<T*>(x.o), st, sh.n_heads, sh.n_kv_heads,
      sh.max_len, sh.window, sh.n_split, sh.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// kG: the query heads per cache head rounded up to 4, 8 or 16. A group of
// 1 (MLA's 40 heads over 40, Zamba2's 32 over 32) takes kG = 4, with 3 of
// every 4 (key, head) lanes of a step idle.
template <typename T, int DQK, int DV>
cudaError_t launch_groups(const Buffers& x, const Strides& st,
                          const Shape& sh, cudaStream_t stream) {
  const int groups = sh.n_heads / sh.n_kv_heads;
  if (groups <= 4) return launch_typed<T, DQK, DV, 4>(x, st, sh, stream);
  if (groups <= 8) return launch_typed<T, DQK, DV, 8>(x, st, sh, stream);
  return launch_typed<T, DQK, DV, kMaxGroups>(x, st, sh, stream);
}

// The (q/k, v) head dims of the instances: (32, 32), (64, 64), (128, 128),
// MLA's (96, 64) (MiniCPM3: qk_nope 64 + qk_rope 32, v 64) and Zamba2's
// (112, 112).
template <typename T>
cudaError_t launch_dim(int head_dim, int v_head_dim, const Buffers& x,
                       const Strides& st, const Shape& sh,
                       cudaStream_t stream) {
  if (head_dim == 32 && v_head_dim == 32)
    return launch_groups<T, 32, 32>(x, st, sh, stream);
  if (head_dim == 64 && v_head_dim == 64)
    return launch_groups<T, 64, 64>(x, st, sh, stream);
  if (head_dim == 128 && v_head_dim == 128)
    return launch_groups<T, 128, 128>(x, st, sh, stream);
  if (head_dim == 96 && v_head_dim == 64)
    return launch_groups<T, 96, 64>(x, st, sh, stream);
  if (head_dim == 112 && v_head_dim == 112)
    return launch_groups<T, 112, 112>(x, st, sh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, D), k_cache (B, S, Hkv, D), v_cache (B, S, Hkv, Dv) and o (B,
// H, Dv) of one dtype (0: float32, 1: bfloat16), with (D, Dv) =
// (head_dim, v_head_dim) one of the instances of launch_dim, read and
// written through the 10 element strides in
// `strides` (q: batch, head; k and v: batch, position, head; o: batch,
// head); pos (B,) int32 on the device; n_split slices per (sequence,
// cache head). The workspace holds
// B * Hkv * n_split * (H / Hkv) * (Dv + 2) floats: part_acc, part_m and
// part_l; `counters` holds B * Hkv int32 tickets, zero before the launch
// and zero again after it. Launches one kernel on `stream` and returns a
// CUDA error code: 0 when the launch was accepted. The caller checks
// shapes, types, devices, alignment, H / Hkv <= 16 and n_split <= 64.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* pos,
                                       float* part_acc, float* part_m,
                                       float* part_l, int* counters, void* o,
                                       const int64_t* strides, int batch,
                                       int n_heads, int n_kv_heads,
                                       int max_len, int head_dim,
                                       int v_head_dim, int dtype,
                                       int window, int n_split,
                                       float scale, void* stream) {
  if (batch <= 0 || n_heads <= 0) return static_cast<int>(cudaSuccess);
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > kMaxGroups || n_split <= 0 ||
      n_split > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9]};
  const Buffers x{q, k, v, pos, part_acc, part_m, part_l, counters, o};
  const Shape sh{batch, n_heads, n_kv_heads, max_len, window, n_split,
                 scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dim<float>(head_dim, v_head_dim, x, st, sh, s);
  else if (dtype == 1)
    err = launch_dim<__nv_bfloat16>(head_dim, v_head_dim, x, st, sh, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
