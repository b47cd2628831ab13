// Fleet-batched NBTI threshold-voltage advance for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `aging_update`
// (src/repro/kernels/aging_update/aging_update.py, `_kernel`): every core
// of the fleet advances its dVth by tau seconds under its own
// (temperature, stress) regime, the paper's Eq. 2 recursion,
//
//     T     = temp_c + 273.15
//     ADF   = K * exp(-E0 / (kB*T)) * exp(c_field*Vdd / (kB*T)) * Y^n
//     dVth' = ADF * ((dVth / ADF)^(1/n) + tau)^n,
//
// with dVth unchanged where stress <= 0 or tau <= 0.
//
// Bound: memory. Each element reads four floats and writes one (20 B)
// against 16 float operations, five of them exp or pow; at
// the fleet sizes of the simulator (8,000 to 1.28M cores) one launch
// moves 0.16 to 25.6 MB, so small fleets are bound by launch latency.
// Design: one thread per element in a grid-stride loop with a masked
// tail, so the wrapper neither pads nor copies. Float32 throughout, in
// the reference's order of operations; precise expf/powf (no fast math)
// and no fused multiply-add, so the result tracks the plain PyTorch
// version to a few ulps.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void aging_update_kernel(const float* __restrict__ dvth,
                                    const float* __restrict__ temp_c,
                                    const float* __restrict__ stress,
                                    const float* __restrict__ tau,
                                    float* __restrict__ out, int64_t n,
                                    float n_exp, float inv_n, float k_fit,
                                    float neg_e0, float kb, float c_vdd) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const float d = dvth[i];
    const float t_k = temp_c[i] + 273.15f;
    const float y = stress[i];
    const float ta = tau[i];
    const float kbt = kb * t_k;
    float adf = k_fit * expf(neg_e0 / kbt);
    adf = adf * expf(c_vdd / kbt);
    adf = adf * powf(y > 0.0f ? y : 1.0f, n_exp);
    const bool live = (y > 0.0f) && (ta > 0.0f);
    const float safe = live ? adf : 1.0f;
    const float eff_t = powf(d / safe, inv_n);
    const float next = safe * powf(eff_t + ta, n_exp);
    out[i] = live ? next : d;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): 0 when the launch
// was accepted. The caller checks shapes, types and devices.
extern "C" int aging_update_launch(const float* dvth, const float* temp_c,
                                   const float* stress, const float* tau,
                                   float* out, int64_t n, float n_exp,
                                   float inv_n, float k_fit, float neg_e0,
                                   float kb, float c_vdd, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  aging_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      dvth, temp_c, stress, tau, out, n, n_exp, inv_n, k_fit, neg_e0, kb,
      c_vdd);
  return static_cast<int>(cudaGetLastError());
}
