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
// against 16 float operations, five of them exp or pow; at the fleet
// sizes of the simulator (8,000 to 1.28M cores) one launch moves 0.16 to
// 25.6 MB. The precise exp and pow take some 200 instructions an element,
// so a large fleet also leans on the issue rate, and a small one (8,000)
// is a chain of dependent transcendental latencies behind the launch.
// Design: the math is skipped where its result is known exactly (a core
// not advanced keeps dVth; a stress of 1 raised to n is 1), so the work
// follows the data. One element a thread in blocks of 256, at most 16
// blocks per SM (the SM count is queried once per device), grid-stride
// with a masked tail, so the wrapper neither pads nor copies and a view
// offset into its storage is read as it is. Blocks of 64 spread over every
// SM measured slower at 8,000 elements (more blocks to launch, and each
// element's chain of exp and pow is as long); four elements a thread by
// 16-byte loads measured no faster at 1.28M than this, once the math was
// skipped. Float32 throughout, in the reference's order of operations;
// precise expf/powf (no fast math) and no fused multiply-add, so the
// result tracks the plain PyTorch version to a few ulps.
#include <algorithm>
#include <cstdint>
#include <vector>

#include <cuda_runtime.h>

namespace {

struct Params {
  float n_exp, inv_n, k_fit, neg_e0, kb, c_vdd;
};

__device__ __forceinline__ float advance(float d, float temp_c, float y,
                                         float ta, const Params& p) {
  // a core that is not stressed, or not advanced, keeps its dVth: skip
  // the math; and powf(1, n) is exactly 1, so a full stress skips a pow
  const bool live = (y > 0.0f) && (ta > 0.0f);
  if (!live) return d;
  const float t_k = temp_c + 273.15f;
  const float kbt = p.kb * t_k;
  float adf = p.k_fit * expf(p.neg_e0 / kbt);
  adf = adf * expf(p.c_vdd / kbt);
  adf = adf * (y == 1.0f ? 1.0f : powf(y, p.n_exp));
  const float eff_t = powf(d / adf, p.inv_n);
  return adf * powf(eff_t + ta, p.n_exp);
}

// Elements [0, n), one a thread, grid-stride.
__global__ void aging_update_kernel(const float* __restrict__ dvth,
                                    const float* __restrict__ temp_c,
                                    const float* __restrict__ stress,
                                    const float* __restrict__ tau,
                                    float* __restrict__ out, int64_t n,
                                    Params p) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    out[i] = advance(dvth[i], temp_c[i], stress[i], tau[i], p);
}

// The current device's SM count into `sms`, queried once per device.
cudaError_t sm_count(int* sms) {
  struct Counts {
    cudaError_t err = cudaSuccess;
    std::vector<int> sms;
  };
  static const Counts counts = [] {
    Counts c;
    int devices = 0;
    c.err = cudaGetDeviceCount(&devices);
    for (int d = 0; c.err == cudaSuccess && d < devices; ++d) {
      int n = 0;
      c.err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, d);
      c.sms.push_back(n);
    }
    return c;
  }();
  if (counts.err != cudaSuccess) return counts.err;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= static_cast<int>(counts.sms.size()) ||
      counts.sms[dev] <= 0)
    return cudaErrorInvalidDevice;
  *sms = counts.sms[dev];
  return cudaSuccess;
}

constexpr int kThreads = 256;   // threads a block
constexpr int kPerSm = 16;      // blocks per SM at most; the rest by stride

}  // namespace

// Launches on `stream` and returns a CUDA error code: 0 when the launch
// was accepted. The caller checks shapes, types and devices.
extern "C" int aging_update_launch(const float* dvth, const float* temp_c,
                                   const float* stress, const float* tau,
                                   float* out, int64_t n, float n_exp,
                                   float inv_n, float k_fit, float neg_e0,
                                   float kb, float c_vdd, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks =
      std::min<int64_t>((n + kThreads - 1) / kThreads, kPerSm * sms);
  const Params p{n_exp, inv_n, k_fit, neg_e0, kb, c_vdd};
  aging_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      dvth, temp_c, stress, tau, out, n, p);
  return static_cast<int>(cudaGetLastError());
}
