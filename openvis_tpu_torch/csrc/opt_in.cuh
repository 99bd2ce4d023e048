// The opt-in of a kernel to more than 48 KB of shared memory, per device.
#pragma once

#include <cuda_runtime.h>

// devices one process can opt in on; a launch on a device beyond fails
constexpr int kMaxOptInDevices = 64;

// Above 48 KB of shared memory, static and dynamic together, a kernel must
// opt in, and cudaFuncSetAttribute acts on the current device only (the
// launchers run under a guard for their tensors' device, so that is the
// launch's device).  `done` holds one flag per device: a static array of the
// caller's, one per kernel instantiation.  The opt-in asks for the most a plan
// may ask, `max_bytes`.
template <typename Kernel>
inline cudaError_t opt_in_shared_memory(Kernel kernel, int max_bytes,
                                        bool (&done)[kMaxOptInDevices]) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxOptInDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
  done[device] = e == cudaSuccess;
  return e;
}
