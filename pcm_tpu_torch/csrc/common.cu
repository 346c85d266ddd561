// C entry shared by the wrappers: readable CUDA error names.
#include <cuda_runtime.h>

extern "C" const char* pcm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
