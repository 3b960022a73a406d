// Shared C entry points of the kernel library.
#include <cuda_runtime.h>

extern "C" const char* upflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
