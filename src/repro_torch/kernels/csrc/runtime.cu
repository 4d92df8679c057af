// Error reporting for the ctypes bindings: every launcher returns a
// cudaError_t as an int, and the wrapper turns a non-zero one into text.
#include <cuda_runtime.h>

extern "C" const char* fc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
