// Function attributes set once per device.
//
// cudaFuncSetAttribute acts on the current device's context only, and the
// wrappers launch on whichever device holds the tensors
// (ops/kernels/_common.py::launch), so a flag that a kernel's attributes
// are set has to be kept for each device.  A launch path holds one
// PerDevice for each kernel instantiation that needs an attribute (more
// than 48 KB of dynamic shared memory, a non-portable cluster size):
//
//   static upflow::PerDevice attrs;
//   const cudaError_t e = attrs.once([&] { return cudaFuncSetAttribute(...); });
//
// Two threads that race on a device's first launch both set the same
// attribute, which is harmless.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace upflow {

class PerDevice {
 public:
  static constexpr int kMaxDevices = 64;

  // Runs `set` (returning a cudaError_t) unless it has already succeeded
  // on the current device; returns its error, or cudaSuccess.
  template <typename Set>
  cudaError_t once(Set&& set) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (done_[dev].load(std::memory_order_acquire)) return cudaSuccess;
    e = set();
    if (e == cudaSuccess) done_[dev].store(true, std::memory_order_release);
    return e;
  }

 private:
  std::atomic<bool> done_[kMaxDevices] = {};
};

}  // namespace upflow
