// Error text for the status every C entry point of this library returns
// (the value of cudaGetLastError() right after its launch).
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
