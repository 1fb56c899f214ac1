// Fused relu-MLP backward for Hopper (sm_90a), f32 throughout.
//
// Replaces gan_mpc_tpu/ops/fused_mlp.py::_bwd_kernel: given x (rows, fin),
// the output cotangent g (rows, fout) and the stack's weights, it
// recomputes the forward, then walks the layers backwards:
//   dW_l = a_l^T g_{l+1},  db_l = sum_rows g_{l+1},
//   g_l  = (g_{l+1} W_l^T) * (a_l > 0)   (no mask for l = 0: dx = g_0),
// where a_0 = x and a_l = relu(layer l-1) are the layer inputs. Weights
// are (in, out) row-major, the JAX package's kernel layout.
//
// What bounds it on an H100: the dx chain and dW take a product per
// layer, the recompute one per layer but the last (dW_{L-1} needs only the
// last layer's input): 2 x rows x (2 sum_l d_l d_{l+1} + sum_{l<L-1}
// d_l d_{l+1}) f32 FMA operations; at the trainer's call (128 rows of the
// 23->200->200->200->17 dynamics stack) that is 67 MFLOP against under
// 1 MB of inputs, outputs, weights and gradients, about 1 us of f32
// throughput. At that size the call is bound by latency: each block
// walks ~1,000 dependent weight rows.
//
// Design (the forward tile loop is mlp_tile.cuh's, shared with the other
// two kernels):
//  * One block owns a tile of TM = 8 * RM rows. It keeps every layer's
//    input activations of the tile in shared memory (the recompute), and
//    the cotangent of the current layer in two ping-pong buffers. Weights
//    stream through shared memory in double-buffered cp.async chunks, as
//    in the forward; the dx chain reads W_l^T, so its chunks are copied
//    transposed (4-byte cp.async, one weight column per chunk row).
//  * The cross-tile sum of dW and db. The TPU kernel's grid runs in order,
//    so its first tile writes and later tiles add. Blocks of a GPU grid run
//    concurrently, so here the sum is a deterministic two-pass reduction:
//    the grid has at most one block per SM, each block walks tiles
//    blockIdx.x, blockIdx.x + gridDim.x, ... and keeps its own sum of
//    them (first tile writes, later tiles add, as on the TPU) in a
//    private slice of a workspace; a second kernel then adds the slices
//    in block order. No atomics, so every run gives the same bits. With
//    one slice (a single tile) the block writes the outputs directly.
//  * RM = 4 (32-row tiles) when there are enough rows for one such block
//    per SM and its shared memory fits, else RM = 1 (8-row tiles, more
//    blocks for the trainer's 128-row calls).
//  * The ragged last tile is masked: rows past `rows` load zeros for x
//    and g, so they add nothing to dW and db, and their dx is not stored.
//  * Plain FMA in f32 (no TF32, no tensor cores): parity with the f32
//    reference is the point of this version.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or -1 for arguments it refuses).

#include "mlp_tile.cuh"

#include <limits.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // a Hopper block's dynamic shared memory
constexpr int kRowsPerThread = 4;     // dW rows a thread accumulates per pass

struct BwdArgs {
  const float* x;   // (rows, dims[0])
  const float* g;   // (rows, dims[L])
  float* dx;        // (rows, dims[0])
  float* part;      // (gridDim.x, total): each block's sum of its tiles
  int rows;
  int total;                // floats of one gradient set: dW_0, db_0, dW_1, ...
  int offset[kMaxLayers];   // where dW_l starts in a set; db_l follows it
};

// One column-width class per call site: CS columns per lane.
#define BY_WIDTH(N, CALL)            \
  if ((N) <= kLanes) {               \
    constexpr int CS = 1;            \
    CALL;                            \
  } else if ((N) <= 2 * kLanes) {    \
    constexpr int CS = 2;            \
    CALL;                            \
  } else if ((N) <= 4 * kLanes) {    \
    constexpr int CS = 4;            \
    CALL;                            \
  } else {                           \
    constexpr int CS = 8;            \
    CALL;                            \
  }

// Start the copy of rows [k0, k0 + n) of W^T into dst ([kk][c], row length
// N), where W is (N, K) row-major: dst[kk * N + c] = W[c * K + k0 + kk].
// Consecutive threads read consecutive k of one weight row.
__device__ __forceinline__ void copy_chunk_t(float* dst, const float* __restrict__ W,
                                             int k0, int n, int K, int N) {
  for (int e = threadIdx.x; e < n * N; e += kThreads) {
    const int c = e / n, kk = e - c * n;
    __pipeline_memcpy_async(dst + kk * N + c, W + (size_t)c * K + k0 + kk, 4);
  }
  __pipeline_commit();
}

// One step of the dx chain for one row tile: out[r][c] = sum_k
// in[r][k] W[c][k] for c < N, W (N, K); then out *= (mask > 0), or, with
// dx set (the first layer), the rows go to global dx unmasked.
template <int RM, int CS>
__device__ __forceinline__ void chain_tile(
    const float* __restrict__ in, float* __restrict__ out, const float* __restrict__ mask,
    float* __restrict__ wbuf, const float* __restrict__ W, int K, int N, int stride,
    float* __restrict__ dx, int row0, int rows) {
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int n_chunks = (K + kChunk - 1) / kChunk;
  const int buf_len = kChunk * N;
  for (int c0 = 0; c0 < N; c0 += kLanes * CS) {
    float acc[RM][CS];
    bool live[CS];
#pragma unroll
    for (int j = 0; j < CS; ++j) {
      live[j] = c0 + lane + kLanes * j < N;
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][j] = 0.f;
    }

    copy_chunk_t(wbuf, W, 0, min(kChunk, K), K, N);
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int k0 = ci * kChunk;
      if (ci + 1 < n_chunks) {
        const int k1 = k0 + kChunk;
        copy_chunk_t(wbuf + ((ci + 1) & 1) * buf_len, W, k1, min(kChunk, K - k1), K, N);
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
        if (dx != nullptr) {
          if (row0 + r < rows) dx[(size_t)(row0 + r) * N + c] = acc[i][j];
        } else {
          out[r * stride + c] = mask[r * stride + c] > 0.f ? acc[i][j] : 0.f;
        }
      }
    }
  }
}

// This tile's share of dW (K, N) = a^T g and db (N) = sum_rows g, written
// to dst (dW, then db) when `first`, else added to it. a (TM, K) and g
// (TM, N) are shared-memory tiles of row stride `stride`. A thread owns
// kRowsPerThread rows of dW (one per row group, so a warp reads one a
// value at a time: a broadcast) and CS columns (consecutive lanes read
// consecutive g values: conflict-free). The same thread owns the same
// entries on every tile, so its read-add-write needs no barrier.
template <int RM, int CS>
__device__ __forceinline__ void dw_tile(const float* __restrict__ a, const float* __restrict__ g,
                                        int K, int N, int stride, float* __restrict__ dst,
                                        bool first) {
  constexpr int TM = kGroups * RM;
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  for (int k0 = 0; k0 < K; k0 += kGroups * kRowsPerThread) {
    for (int c0 = 0; c0 < N; c0 += kLanes * CS) {
      float acc[kRowsPerThread][CS];
      bool live_k[kRowsPerThread], live_c[CS];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        live_k[i] = k0 + group + kGroups * i < K;
#pragma unroll
        for (int j = 0; j < CS; ++j) acc[i][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < CS; ++j) live_c[j] = c0 + lane + kLanes * j < N;
#pragma unroll 4
      for (int r = 0; r < TM; ++r) {
        float gv[CS], av[kRowsPerThread];
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          gv[j] = live_c[j] ? g[r * stride + c0 + lane + kLanes * j] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          av[i] = live_k[i] ? a[r * stride + k0 + group + kGroups * i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
          for (int j = 0; j < CS; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          if (!live_k[i] || !live_c[j]) continue;
          const size_t idx = (size_t)(k0 + group + kGroups * i) * N + c0 + lane + kLanes * j;
          dst[idx] = first ? acc[i][j] : dst[idx] + acc[i][j];
        }
      }
    }
  }
  float* db = dst + (size_t)K * N;
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += g[r * stride + c];
    db[c] = first ? s : db[c] + s;
  }
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
fused_mlp_bwd_kernel(BwdArgs a, MlpArgs mlp, int stride, int n_tiles) {
  constexpr int TM = kGroups * RM;
  extern __shared__ __align__(16) float smem[];
  const int L = mlp.n_layers;
  const int tile_len = TM * stride;
  float* act = smem;  // L tiles: act_l = the input of layer l
  float* gin = smem + L * tile_len;  // the cotangent of the current layer's output
  float* gout = gin + tile_len;      // ... and of its input
  float* wbuf = smem + (L + 2) * tile_len;  // 2 x kChunk x stride
  float* part = a.part + (size_t)blockIdx.x * a.total;
  const int fin = mlp.dims[0], fout = mlp.dims[L];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TM;
    const bool first = tile == (int)blockIdx.x;
    for (int idx = threadIdx.x; idx < TM * fin; idx += kThreads) {
      const int r = idx / fin, k = idx - r * fin;
      act[r * stride + k] = row0 + r < a.rows ? a.x[(size_t)(row0 + r) * fin + k] : 0.f;
    }
    for (int idx = threadIdx.x; idx < TM * fout; idx += kThreads) {
      const int r = idx / fout, c = idx - r * fout;
      gin[r * stride + c] = row0 + r < a.rows ? a.g[(size_t)(row0 + r) * fout + c] : 0.f;
    }
    __syncthreads();

    // forward recompute: act_{l+1} = relu(act_l W_l + b_l), l < L - 1
    for (int l = 0; l + 1 < L; ++l) {
      const int K = mlp.dims[l], N = mlp.dims[l + 1];
      BY_WIDTH(N, (layer_tile<RM, CS, false>(act + l * tile_len, act + (l + 1) * tile_len, wbuf,
                                             mlp.w[l], nullptr, K, mlp.b[l], K, N, stride, false,
                                             nullptr, row0, a.rows, nullptr, 0)));
      __syncthreads();
    }

    // backward: gin holds g_{l+1}, the cotangent of layer l's output
    for (int l = L - 1; l >= 0; --l) {
      const int K = mlp.dims[l], N = mlp.dims[l + 1];
      const float* al = act + l * tile_len;
      BY_WIDTH(N, (dw_tile<RM, CS>(al, gin, K, N, stride, part + a.offset[l], first)));
      BY_WIDTH(K, (chain_tile<RM, CS>(gin, gout, al, wbuf, mlp.w[l], N, K, stride,
                                      l == 0 ? a.dx : nullptr, row0, a.rows)));
      __syncthreads();
      float* t = gin;
      gin = gout;
      gout = t;
    }
  }
}

// out[e] = sum over p < parts of part[p * total + e], in the order of p.
__global__ void __launch_bounds__(kThreads)
sum_parts_kernel(const float* __restrict__ part, int parts, int total, float* __restrict__ out) {
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += part[(size_t)p * total + e];
    out[e] = s;
  }
}

// Dynamic shared memory of one block: L activation tiles and two
// cotangent tiles of TM rows, and two weight chunks, all of row stride
// `stride`.
template <int RM>
constexpr size_t smem_bytes(int n_layers, int stride) {
  return ((n_layers + 2ull) * kGroups * RM * stride + 2ull * kChunk * stride) * sizeof(float);
}

template <int RM>
cudaError_t allow_max_smem(int device) {
  static bool done[kMaxDevices];
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e == cudaSuccess && device < kMaxDevices) done[device] = true;
  return e;
}

// The launch's shape: rows per tile (8 * rm), tiles, and blocks (= the
// number of partial gradient sets). Returns 0, a cudaError_t value, or -1
// for a stack whose tile does not fit in shared memory.
struct Plan {
  int rm, tiles, blocks;
};

int make_plan(int rows, int n_layers, int stride, Plan* p) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return (int)e;
  if (rows >= sms * kGroups * 4 && smem_bytes<4>(n_layers, stride) <= kMaxSmem) {
    p->rm = 4;
  } else if (smem_bytes<1>(n_layers, stride) <= kMaxSmem) {
    p->rm = 1;
  } else {
    return -1;
  }
  const int tm = kGroups * p->rm;
  p->tiles = (rows + tm - 1) / tm;
  p->blocks = p->tiles < sms ? p->tiles : sms;
  return 0;
}

template <int RM>
cudaError_t launch(const BwdArgs& a, const MlpArgs& mlp, int stride, int n_tiles, int blocks,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<RM>(mlp.n_layers, stride);
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = allow_max_smem<RM>(device);
    if (e != cudaSuccess) return e;
  }
  fused_mlp_bwd_kernel<RM><<<blocks, kThreads, smem, stream>>>(a, mlp, stride, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, dims[0]), g (rows, dims[n_layers]) -> dx (rows, dims[0]) and
// grads, one flat set dW_0 (dims[0], dims[1]), db_0 (dims[1]), dW_1, ...
// Weights[l] (dims[l], dims[l+1]) and biases[l] (dims[l+1]) as in the
// forward. `work` holds work_parts gradient sets, one per block of a
// launch over several tiles; the grid has at most one block per SM, so
// work_parts = the device's SM count always suffices. All pointers are
// device pointers to contiguous f32. Returns 0 on a successful launch, a
// cudaError_t value if a launch failed, or -1 for arguments the kernel
// does not take (a workspace too small for the launch among them).
int fused_mlp_bwd(const float* x, const float* g, float* dx, float* grads, float* work,
                  int work_parts, int rows, int n_layers, const int* dims,
                  const float* const* weights, const float* const* biases, void* stream) {
  MlpArgs mlp;
  if (rows < 0) return -1;
  const int stride = fill_mlp_args(&mlp, n_layers, dims, weights, biases);
  if (stride < 0 || rows > INT_MAX / stride) return -1;
  BwdArgs a;
  a.x = x;
  a.g = g;
  a.dx = dx;
  a.rows = rows;
  long long total = 0;
  for (int l = 0; l < n_layers; ++l) {
    a.offset[l] = (int)total;
    total += (long long)dims[l] * dims[l + 1] + dims[l + 1];
  }
  a.total = (int)total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows == 0) return (int)cudaMemsetAsync(grads, 0, total * sizeof(float), s);
  Plan p;
  const int e = make_plan(rows, n_layers, stride, &p);
  if (e != 0) return e;
  if (p.blocks > 1 && (work == nullptr || work_parts < p.blocks)) return -1;
  a.part = p.blocks > 1 ? work : grads;
  cudaError_t err = p.rm == 4 ? launch<4>(a, mlp, stride, p.tiles, p.blocks, s)
                              : launch<1>(a, mlp, stride, p.tiles, p.blocks, s);
  if (err != cudaSuccess || p.blocks == 1) return (int)err;
  const int blocks = (a.total + kThreads - 1) / kThreads;
  sum_parts_kernel<<<blocks, kThreads, 0, s>>>(work, p.blocks, a.total, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
