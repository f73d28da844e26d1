// Text of a cudaError_t returned by a kernel entry point.

#include <cuda_runtime.h>

extern "C" const char* rfnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
