// Error text for the codes the launchers of this directory return.
#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
