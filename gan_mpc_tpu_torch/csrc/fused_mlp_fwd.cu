// Fused relu-MLP forward for Hopper (sm_90a), f32 throughout.
//
// Replaces gan_mpc_tpu/ops/fused_mlp.py::_fwd_kernel: for every row,
//   h = x;  h = h @ W_l + b_l  for each layer l,  relu on all but the last.
// Weights are (in, out) row-major, the JAX package's kernel layout.
//
// What bounds it on an H100: at the planner's largest call (8192 rows of
// the 23->200->200->200->17 dynamics stack) one call is about 1.4 GFLOP
// of f32 FMA against about 1.3 MB of activations in and out
// (8192 x (23 + 17) x 4 B) plus 354 KB of weights. So the call is bound
// by f32 FMA throughput and by the shared-memory reads that feed it, not by
// device memory, as long as the hidden activations never leave the SM.
// At 512 rows (the rollout and the winner recompute) the same stack is
// ~90 MFLOP, and the call is bound by latency: few blocks, each walking
// 600 dependent weight rows.
//
// Design:
//  * One block owns a tile of TM rows for the WHOLE stack. The tile's
//    activations ping-pong between two shared-memory buffers (TM x
//    max_width floats each), so no hidden activation touches device
//    memory: traffic is x in, y out, and the weights.
//  * The TPU kernel keeps every weight resident in VMEM. The dynamics
//    stack's 354 KB do not fit in the 227 KB of shared memory a Hopper
//    block can have, so each layer's weights stream through shared memory
//    in chunks of KC rows, double-buffered with cp.async: the copy of
//    chunk c+1 is in flight while chunk c is multiplied. Every block reads
//    the same weights, so after the first blocks they come from L2.
//  * 256 threads = 8 row groups x 32 column lanes. A thread accumulates RM
//    rows x CS columns in registers (columns lane + 32 j); per k it reads
//    CS weights (consecutive lanes, conflict-free) and RM activations
//    (a broadcast: all lanes of a warp read the same row). CS is picked per
//    layer from its width (1, 2, 4 or 8 columns per lane), so a 17-wide
//    last layer does not pay for 256 columns; a layer wider than 256 runs
//    as two column slabs.
//  * TM = 8 * RM. RM = 4 (32 rows per block) when there are enough rows
//    for a block per SM (the SM count is read from the device), else
//    RM = 1 (8 rows per block) so that 512 rows still spread over 64 SMs.
//  * The ragged last tile is masked here: rows past `rows` load zeros and
//    are never stored. There is no padding copy.
//  * Plain FMA in f32 (no TF32, no tensor cores): parity with the f32
//    reference is the point of this version. wgmma/TMA/bf16 come later.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or -1 for arguments it refuses).

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

struct MlpArgs {
  int n_layers;
  int dims[kMaxLayers + 1];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
};

// Start the asynchronous copy of weight rows [k0, k0 + n) of W (row
// length N) into dst. The chunk is contiguous in W.
__device__ __forceinline__ void copy_chunk(float* dst, const float* __restrict__ W,
                                           int k0, int n, int N) {
  const float* src = W + (size_t)k0 * N;
  const int count = n * N;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = count & ~3;
    for (int i = threadIdx.x * 4; i < done; i += kThreads * 4) {
      __pipeline_memcpy_async(dst + i, src + i, 16);
    }
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) {
    __pipeline_memcpy_async(dst + i, src + i, 4);
  }
  __pipeline_commit();
}

// One layer for one row tile: out[r][c] = act(sum_k in[r][k] W[k][c] + b[c])
// for c in [0, N). in/out are shared-memory tiles with row stride `stride`;
// wbuf holds two weight chunks of kChunk x N floats. The last layer writes
// straight to global y (masked by `rows`).
template <int RM, int CS>
__device__ __forceinline__ void layer_tile(
    const float* __restrict__ in, float* __restrict__ out, float* __restrict__ wbuf,
    const float* __restrict__ W, const float* __restrict__ bias,
    int K, int N, int stride, bool last,
    float* __restrict__ y, int row0, int rows) {
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

    copy_chunk(wbuf, W, 0, min(kChunk, K), N);
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int k0 = ci * kChunk;
      if (ci + 1 < n_chunks) {
        const int k1 = k0 + kChunk;
        copy_chunk(wbuf + ((ci + 1) & 1) * buf_len, W, k1, min(kChunk, K - k1), N);
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
          if (row0 + r < rows) y[(size_t)(row0 + r) * N + c] = acc[i][j];
        } else {
          out[r * stride + c] = fmaxf(acc[i][j], 0.f);
        }
      }
    }
  }
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
fused_mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                     int rows, int stride, MlpArgs args) {
  constexpr int TM = kGroups * RM;
  extern __shared__ __align__(16) float smem[];
  float* in = smem;
  float* out = smem + TM * stride;
  float* wbuf = smem + 2 * TM * stride;  // 2 x kChunk x stride floats
  const int row0 = blockIdx.x * TM;

  const int fin = args.dims[0];
  for (int idx = threadIdx.x; idx < TM * fin; idx += kThreads) {
    const int r = idx / fin, k = idx - r * fin;
    const int g = row0 + r;
    in[r * stride + k] = g < rows ? x[(size_t)g * fin + k] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < args.n_layers; ++l) {
    const int K = args.dims[l], N = args.dims[l + 1];
    const bool last = l == args.n_layers - 1;
    const float* W = args.w[l];
    const float* b = args.b[l];
    if (N <= kLanes) {
      layer_tile<RM, 1>(in, out, wbuf, W, b, K, N, stride, last, y, row0, rows);
    } else if (N <= 2 * kLanes) {
      layer_tile<RM, 2>(in, out, wbuf, W, b, K, N, stride, last, y, row0, rows);
    } else if (N <= 4 * kLanes) {
      layer_tile<RM, 4>(in, out, wbuf, W, b, K, N, stride, last, y, row0, rows);
    } else {
      layer_tile<RM, 8>(in, out, wbuf, W, b, K, N, stride, last, y, row0, rows);
    }
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }
}

// Dynamic shared memory of one block: two activation tiles of TM rows
// and two weight chunks, all of row stride `stride`.
template <int RM>
constexpr size_t smem_bytes(int stride) {
  return (2ull * kGroups * RM * stride + 2ull * kChunk * stride) * sizeof(float);
}

constexpr int kMaxDevices = 64;

// Raise the instance's dynamic shared-memory limit to what the widest
// stack needs, once per device: the attribute call costs host time, and
// the planner's launches are bound by host time.
template <int RM>
cudaError_t allow_max_smem(int device) {
  static bool done[kMaxDevices];
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<RM>(kMaxWidth));
  if (e == cudaSuccess && device < kMaxDevices) done[device] = true;
  return e;
}

template <int RM>
cudaError_t launch(const float* x, float* y, int rows, int stride,
                   const MlpArgs& args, int device, cudaStream_t stream) {
  constexpr int TM = kGroups * RM;
  // the stride is a multiple of 4 floats so that every buffer stays
  // 16-byte aligned for cp.async
  const size_t smem = smem_bytes<RM>(stride);
  if (smem > 48 * 1024) {
    cudaError_t e = allow_max_smem<RM>(device);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (rows + TM - 1) / TM;
  fused_mlp_fwd_kernel<RM><<<blocks, kThreads, smem, stream>>>(x, y, rows, stride, args);
  return cudaGetLastError();
}

// The device's SM count, read once per device.
cudaError_t sm_count(int device, int* count) {
  static int cached[kMaxDevices];
  if (device < kMaxDevices && cached[device] > 0) {
    *count = cached[device];
    return cudaSuccess;
  }
  cudaError_t e = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && device < kMaxDevices) cached[device] = *count;
  return e;
}

}  // namespace

extern "C" {

// x (rows, dims[0]) -> y (rows, dims[n_layers]); weights[l] (dims[l],
// dims[l+1]) and biases[l] (dims[l+1]) are device pointers, all f32 and
// contiguous. Returns 0 on a successful launch, a cudaError_t value if the
// launch failed, or -1 for arguments the kernel does not take.
int fused_mlp_fwd(const float* x, float* y, int rows, int n_layers,
                  const int* dims, const float* const* weights,
                  const float* const* biases, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || rows < 0) return -1;
  MlpArgs args;
  args.n_layers = n_layers;
  int stride = 4;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return -1;
    args.dims[l] = dims[l];
    if (dims[l] > stride) stride = dims[l];
  }
  stride = (stride + 3) & ~3;
  for (int l = 0; l < n_layers; ++l) {
    args.w[l] = weights[l];
    args.b[l] = biases[l];
  }
  if (rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return (int)e;
  // 32-row tiles once there are enough rows for one such block per SM,
  // else 8-row tiles so that the rows still spread over the SMs
  if (rows >= sms * kGroups * 4) {
    return (int)launch<4>(x, y, rows, stride, args, device, s);
  }
  return (int)launch<1>(x, y, rows, stride, args, device, s);
}

}  // extern "C"
