// The entry point every kernel library exports beside its kernels:
// ops/_build.py check() turns the CUDA error code a launch returned into
// its text through it.  Each library compiles one .cu file, so the
// definition is made once per library.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* fabric_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
