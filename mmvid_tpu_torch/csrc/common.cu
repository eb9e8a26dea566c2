// C entry points shared by the kernel wrappers.

#include "common.cuh"

extern "C" const char* mmvid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
