// Device code shared by the fused-MLP kernels: the description of a stack
// (MlpArgs, fill_mlp_args), the SM count, and the f32 FMA layer loop that
// the backward kernel (fused_mlp_bwd.cu) recomputes its forward with. The
// two forward kernels (fused_mlp_fwd.cu, fused_ls_step.cu) multiply on the
// tensor cores with the loop of mlp_tile_mma.cuh and take only the stack
// description from here.
//
// layer_tile, one layer over one tile of TM = 8 * RM rows, f32 throughout:
//  * The tile's input and output activations are shared-memory buffers
//    (TM x stride floats each), so no hidden activation touches device
//    memory.
//  * The layer's weights stream through shared memory in chunks of kChunk
//    rows, double-buffered with cp.async: the copy of chunk c+1 is in
//    flight while chunk c is multiplied. Every block reads the same
//    weights, so after the first blocks they come from L2.
//  * 256 threads = 8 row groups x 32 column lanes. A thread accumulates RM
//    rows x CS columns in registers (columns lane + 32 j); per k it reads
//    CS weights (consecutive lanes, conflict-free) and RM activations (a
//    broadcast: all lanes of a warp read the same row). CS is picked per
//    layer from its width (1, 2, 4 or 8 columns per lane); a layer wider
//    than 256 runs as two column slabs.
//  * Plain FMA in f32 (no tensor cores), so the backward's relu masks come
//    from the same arithmetic as its own products.
//  * The template flag kLs (W0 in two tensors, a residual added to the
//    output) is false in the backward kernel.
//
// Everything here sits in an anonymous namespace: each kernel source
// builds into a library of its own.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 512;
constexpr int kThreads = 256;
constexpr int kLanes = 32;                  // column lanes per row group
constexpr int kGroups = kThreads / kLanes;  // row groups
constexpr int kChunk = 16;                  // weight rows per streamed chunk
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

// Start asynchronous copies of `count` consecutive floats, 16 bytes at a
// time where `aligned` (both ends 16-byte aligned).
__device__ __forceinline__ void copy_span(float* dst, const float* __restrict__ src,
                                          int count, bool aligned) {
  int done = 0;
  if (aligned) {
    done = count & ~3;
    for (int i = threadIdx.x * 4; i < done; i += kThreads * 4) {
      __pipeline_memcpy_async(dst + i, src + i, 16);
    }
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) {
    __pipeline_memcpy_async(dst + i, src + i, 4);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Start the copy of weight rows [k0, k0 + n) (row length N) into dst, a
// 16-byte aligned chunk buffer. With kLs, rows below `split` come from W
// and the others from Wtail; else all from W.
template <bool kLs>
__device__ __forceinline__ void copy_chunk(float* dst, const float* __restrict__ W,
                                           const float* __restrict__ Wtail, int split,
                                           int k0, int n, int N) {
  if constexpr (kLs) {
    const int head = max(0, min(n, split - k0));
    if (head > 0) {
      const float* src = W + (size_t)k0 * N;
      copy_span(dst, src, head * N, aligned16(src));
    }
    if (head < n) {
      const float* src = Wtail + (size_t)(k0 + head - split) * N;
      copy_span(dst + head * N, src, (n - head) * N, aligned16(src) && aligned16(dst + head * N));
    }
  } else {
    const float* src = W + (size_t)k0 * N;
    copy_span(dst, src, n * N, aligned16(src));
  }
  __pipeline_commit();
}

// One layer for one row tile: out[r][c] = act(sum_k in[r][k] W[k][c] + b[c])
// for c in [0, N). in/out are shared-memory tiles with row stride `stride`;
// wbuf holds two weight chunks of kChunk x N floats. The last layer writes
// straight to global y (masked by `rows`), with kLs adding resid[r *
// resid_stride + c].
template <int RM, int CS, bool kLs>
__device__ __forceinline__ void layer_tile(
    const float* __restrict__ in, float* __restrict__ out, float* __restrict__ wbuf,
    const float* __restrict__ W, const float* __restrict__ Wtail, int split,
    const float* __restrict__ bias, int K, int N, int stride, bool last,
    float* __restrict__ y, int row0, int rows,
    const float* __restrict__ resid, int resid_stride) {
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int n_chunks = (K + kChunk - 1) / kChunk;
  const int buf_len = kChunk * N;
  // column slabs of 32 * CS columns; a layer wider than 256 takes two
  // passes over its weights (registers stay at RM x 8 accumulators)
  for (int c0 = 0; c0 < N; c0 += kLanes * CS) {
    float acc[RM][CS];
    bool live[CS];
#pragma unroll
    for (int j = 0; j < CS; ++j) {
      const int c = c0 + lane + kLanes * j;
      live[j] = c < N;
      const float bj = live[j] ? __ldg(bias + c) : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][j] = bj;
    }

    copy_chunk<kLs>(wbuf, W, Wtail, split, 0, min(kChunk, K), N);
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int k0 = ci * kChunk;
      if (ci + 1 < n_chunks) {
        const int k1 = k0 + kChunk;
        copy_chunk<kLs>(wbuf + ((ci + 1) & 1) * buf_len, W, Wtail, split, k1,
                        min(kChunk, K - k1), N);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const float* ws = wbuf + (ci & 1) * buf_len + c0 + lane;
      const int n = min(kChunk, K - k0);
#pragma unroll 4
      for (int kk = 0; kk < n; ++kk) {
        float w[CS];
#pragma unroll
        for (int j = 0; j < CS; ++j) w[j] = live[j] ? ws[kk * N + kLanes * j] : 0.f;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float a = in[(group + kGroups * i) * stride + k0 + kk];
#pragma unroll
          for (int j = 0; j < CS; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
        }
      }
      __syncthreads();  // the next copy into this buffer starts after this
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = group + kGroups * i;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        if (!live[j]) continue;
        const int c = c0 + lane + kLanes * j;
        if (last) {
          if (row0 + r < rows) {
            float v = acc[i][j];
            if constexpr (kLs) v += resid[r * resid_stride + c];
            y[(size_t)(row0 + r) * N + c] = v;
          }
        } else {
          out[r * stride + c] = fmaxf(acc[i][j], 0.f);
        }
      }
    }
  }
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

// Copy the host's stack description into MlpArgs; returns the activation
// row stride (the widest layer, rounded up to 4 floats so that every
// shared buffer stays 16-byte aligned for cp.async), or -1 for a stack
// the kernels do not take.
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
