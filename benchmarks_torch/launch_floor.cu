// An empty kernel, launched with a given geometry: the floor of a launch
// of that shape on the card, timed beside a kernel of the same geometry
// (chip_smoke.py times it beside the aging kernel). Build with the port's
// nvcc flags (`repro_torch.kernels._build`).
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches `blocks` blocks of `threads` threads on `stream`; returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int empty_launch(unsigned blocks, unsigned threads,
                            void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
