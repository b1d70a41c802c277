// empty: a kernel that does nothing, launched as the port's kernels are
// (ctypes, the current stream). Its device time between back-to-back
// launches is the launch floor that chip_smoke.py and kernel_times.py
// read the small kernels' times against (the SMO row and selection
// kernels take a few microseconds). Not a port of any TPU kernel.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int svm_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
