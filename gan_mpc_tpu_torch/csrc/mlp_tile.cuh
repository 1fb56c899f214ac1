// The description of a relu-MLP stack that the three fused kernels share
// and the device's SM count. The kernels (fused_mlp_fwd.cu,
// fused_ls_step.cu, fused_mlp_bwd.cu) multiply on the tensor cores with the
// tile loop of mlp_tile_mma.cuh, which includes this file.
//
// A stack reaches a kernel in one of two forms. Up to kInlineLayers
// layers it travels in the launch's parameters (MlpArgs), and the kernels
// keep its activations in shared memory: every committed stack takes that
// path. A deeper or wider one travels as a table, and the wide kernels
// walk any number of layers of any width: the forward kernels' table
// (WideTable, mlp_tile_mma.cuh) in the launch's parameters up to
// kTableLayers layers, the further ones at the head of the caller's
// workspace; the backward's (LayerDesc, MlpTable) is copied into the head
// of the caller's workspace at each launch (fused_mlp_bwd.cu).
//
// Everything here sits in an anonymous namespace: each kernel source
// builds into a library of its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kInlineLayers = 8;  // layers that travel in the launch's parameters
constexpr int kMaxDevices = 64;

// A stack of (W (dims[l], dims[l+1]) row-major, b (dims[l+1])) layers.
// The first layer's rows may live in two tensors: rows [0, split) in w[0]
// and rows [split, dims[0]) in w0_tail, as the line-search step's W0 is
// split into its state rows and its action rows. split == dims[0] when W0
// is one tensor.
struct MlpArgs {
  int n_layers;
  int dims[kInlineLayers + 1];
  const float* w[kInlineLayers];
  const float* b[kInlineLayers];
  const float* w0_tail;
  int split;
};

// One layer of a stack as the wide kernels read it from device memory.
struct LayerDesc {
  const float* w;  // (K, N) row-major
  const float* b;  // (N)
  int K, N;
  int step;        // weight rows per chunk of the ring: whole k-steps of 8
  int at;          // backward: where the layer's input planes start, floats
  int sa;          // backward: their row stride
  int offset;      // backward: where dW starts in a gradient set; db follows it
};

// A stack of any depth: n_layers LayerDescs in device memory (the
// backward's table has one more, which places the output cotangent's
// planes), and W0's tail as in MlpArgs.
struct MlpTable {
  int n_layers;
  const LayerDesc* layer;
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

// The widest layer of the host's stack description rounded up to 4
// floats, or -1 for a description that is no stack (no layer, or a width
// under 1).
inline int stack_width(int n_layers, const int* dims) {
  if (n_layers < 1) return -1;
  int stride = 4;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return -1;
    if (dims[l] > stride) stride = dims[l];
  }
  return (stride + 3) & ~3;
}

// Copy the host's stack description into MlpArgs: a stack of at most
// kInlineLayers layers (stack_width checked).
inline void fill_mlp_args(MlpArgs* args, int n_layers, const int* dims,
                          const float* const* weights, const float* const* biases) {
  args->n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) args->dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    args->w[l] = weights[l];
    args->b[l] = biases[l];
  }
  args->w0_tail = nullptr;
  args->split = dims[0];
}

// The host's side of a table: one LayerDesc per layer, plus `extra`
// entries of zeros, their plan fields left for the caller.
inline std::vector<LayerDesc> layer_table(int n_layers, const int* dims,
                                          const float* const* weights,
                                          const float* const* biases, int extra) {
  std::vector<LayerDesc> t(n_layers + extra, LayerDesc{});
  for (int l = 0; l < n_layers; ++l) {
    t[l].w = weights[l];
    t[l].b = biases[l];
    t[l].K = dims[l];
    t[l].N = dims[l + 1];
  }
  return t;
}

}  // namespace
