// Runtime entries of the ctypes bindings: every launcher returns a
// cudaError_t as an int, and the wrapper turns a non-zero one into text;
// the launch checks read the card's limits.
#include <cuda_runtime.h>

extern "C" const char* fc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The card's launch limits: out[0..5) = largest grid x, y, z, opt-in shared
// memory a CTA may have, and warp size.
extern "C" int fc_device_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const cudaDeviceAttr attrs[5] = {
      cudaDevAttrMaxGridDimX, cudaDevAttrMaxGridDimY, cudaDevAttrMaxGridDimZ,
      cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrWarpSize};
  for (int i = 0; i < 5; ++i) {
    e = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
