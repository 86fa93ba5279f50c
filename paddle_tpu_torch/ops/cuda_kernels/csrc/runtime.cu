// Error strings for the cudaError_t codes the port's C entry points return.

#include <cuda_runtime.h>

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
