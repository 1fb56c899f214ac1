// The description of a relu-MLP stack that the three fused kernels share
// (MlpArgs, fill_mlp_args) and the device's SM count. The kernels
// (fused_mlp_fwd.cu, fused_ls_step.cu, fused_mlp_bwd.cu) multiply on the
// tensor cores with the tile loop of mlp_tile_mma.cuh, which includes
// this file.
//
// Everything here sits in an anonymous namespace: each kernel source
// builds into a library of its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 512;
constexpr int kMaxDevices = 64;

// A stack of (W (dims[l], dims[l+1]) row-major, b (dims[l+1])) layers.
// The first layer's rows may live in two tensors: rows [0, split) in w[0]
// and rows [split, dims[0]) in w0_tail, as the line-search step's W0 is
// split into its state rows and its action rows. split == dims[0] when W0
// is one tensor.
struct MlpArgs {
  int n_layers;
  int dims[kMaxLayers + 1];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  const float* w0_tail;
  int split;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The device's SM count, read once per device.
inline cudaError_t sm_count(int device, int* count) {
  static int cached[kMaxDevices];
  if (device < kMaxDevices && cached[device] > 0) {
    *count = cached[device];
    return cudaSuccess;
  }
  cudaError_t e = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && device < kMaxDevices) cached[device] = *count;
  return e;
}

// Copy the host's stack description into MlpArgs; returns the widest
// layer's width rounded up to 4 floats, or -1 for a stack the kernels do
// not take.
inline int fill_mlp_args(MlpArgs* args, int n_layers, const int* dims,
                         const float* const* weights, const float* const* biases) {
  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  args->n_layers = n_layers;
  int stride = 4;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return -1;
    args->dims[l] = dims[l];
    if (dims[l] > stride) stride = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    args->w[l] = weights[l];
    args->b[l] = biases[l];
  }
  args->w0_tail = nullptr;
  args->split = dims[0];
  return (stride + 3) & ~3;
}

}  // namespace
