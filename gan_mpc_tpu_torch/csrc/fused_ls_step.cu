// Fused line-search / rollout step of the batch iLQR solver for Hopper
// (sm_90a), f32 throughout.
//
// Replaces gan_mpc_tpu/ops/fused_ls.py::_kernel. For every row
// g = b * A + a of B lanes x A step sizes:
//   u    = Uref[b] + alpha[g] * k[b] + K[b] (x[g] - Xref[b])   (control law)
//   nx   = x + MLP([x, u])                                     (residual dynamics)
//   cost = w_u sn(u) + w_x sn(x[:gs] - goal[b])
//          + w_ag ag(u - gain * goal_u[b])                     (stage cost)
// with sn(v) = sqrt(|v|^2 + a^2) - a, a = 1e-2, and ag(d) = ag_scale |d|^2
// (squared action goal) or ag_scale sn(d); wvec = [w_u, w_x, w_ag, gain]
// stays on the device. W0 comes split in two, its state rows and its
// action rows, as the TPU kernel takes it.
//
// What bounds it on an H100: at the line search's call (512 lanes x 16
// step sizes = 8192 rows, 23->200->200->200->17 dynamics) the MLP is
// 2 x 8192 x 88,000 = 1.44 GFLOP of f32 FMA against about 2 MB of inputs,
// outputs and weights, so the call is bound by f32 FMA throughput (and the
// shared-memory reads that feed it), not by device memory. The control
// law and the cost add under 1% of the operations. At 512 rows (the
// rollout and the winner recompute, A = 1) it is bound by latency.
//
// Design:
//  * One block owns a tile of TM = 8 * RM rows. It loads the tile's
//    states once into shared memory, forms u there (one thread per row
//    and action; the lane's Xref, Uref, k and K rows are read through the
//    read-only cache, shared by the A rows of a lane), writes u and the
//    stage cost, and runs the dynamics MLP on [x, u] with the tile loop
//    of mlp_tile.cuh: activations in shared memory, weights streamed in
//    double-buffered cp.async chunks. The last layer adds the kept input
//    state, so nx = x + MLP([x, u]) leaves the block in one store.
//  * The state term of the cost uses the INPUT x, not nx.
//  * RM = 4 (32-row tiles) when there are enough rows for one such block
//    per SM and the block's shared memory fits, else RM = 1, so that the
//    512-row calls still spread over 64 SMs.
//  * The ragged last tile is masked: rows past B * A load zeros and are
//    never stored.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or -1 for arguments it refuses).

#include "mlp_tile.cuh"

namespace {

constexpr float kHuberAlpha = 1e-2f;  // models/cost.py _HUBER_ALPHA
constexpr size_t kMaxSmem = 232448;   // a Hopper block's dynamic shared memory

struct LsArgs {
  const float* x3;      // (B, A, n)
  const float* xref;    // (B, n)
  const float* uref;    // (B, m)
  const float* alpha;   // (B, A)
  const float* k;       // (B, m)
  const float* K;       // (B, m, n)
  const float* goal;    // (B, gs)
  const float* goal_u;  // (B, m)
  const float* wvec;    // (4,) w_u, w_x, w_ag, gain
  float* nx;            // (B, A, n)
  float* u;             // (B, A, m)
  float* cost;          // (B, A)
  int B, A, n, m, gs;
  int ag_squared;
  float ag_scale;
};

__device__ __forceinline__ float pseudo_huber(float sq) {
  return sqrtf(sq + kHuberAlpha * kHuberAlpha) - kHuberAlpha;
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
fused_ls_step_kernel(LsArgs a, MlpArgs mlp, int stride) {
  constexpr int TM = kGroups * RM;
  extern __shared__ __align__(16) float smem[];
  float* in = smem;                        // TM x stride: [x, u], then activations
  float* out = smem + TM * stride;         // TM x stride
  float* wbuf = smem + 2 * TM * stride;    // 2 x kChunk x stride
  float* xs = wbuf + 2 * kChunk * stride;  // TM x n: the input states
  const int rows = a.B * a.A;
  const int row0 = blockIdx.x * TM;
  const int n = a.n, m = a.m;

  // 1. the tile's states
  for (int idx = threadIdx.x; idx < TM * n; idx += kThreads) {
    const int r = idx / n, c = idx - r * n;
    const int g = row0 + r;
    const float v = g < rows ? a.x3[(size_t)g * n + c] : 0.f;
    in[r * stride + c] = v;
    xs[r * n + c] = v;
  }
  __syncthreads();

  // 2. control law, one thread per (row, action)
  for (int idx = threadIdx.x; idx < TM * m; idx += kThreads) {
    const int r = idx / m, j = idx - r * m;
    const int g = row0 + r;
    float uj = 0.f;
    if (g < rows) {
      const int b = g / a.A;
      const float* Kj = a.K + ((size_t)b * m + j) * n;
      const float* xr = a.xref + (size_t)b * n;
      float du = 0.f;
      for (int i = 0; i < n; ++i) du = fmaf(__ldg(Kj + i), xs[r * n + i] - __ldg(xr + i), du);
      uj = __ldg(a.uref + (size_t)b * m + j) + __ldg(a.alpha + g) * __ldg(a.k + (size_t)b * m + j)
           + du;
      a.u[(size_t)g * m + j] = uj;
    }
    in[r * stride + n + j] = uj;
  }
  __syncthreads();

  // 3. stage cost, one thread per row. It only reads `in` and `xs`; the
  // MLP below first writes `in` after its first layer's barrier.
  if (threadIdx.x < TM) {
    const int r = threadIdx.x;
    const int g = row0 + r;
    if (g < rows) {
      const int b = g / a.A;
      const float* ur = in + r * stride + n;
      const float w_u = __ldg(a.wvec), w_x = __ldg(a.wvec + 1);
      const float w_ag = __ldg(a.wvec + 2), gain = __ldg(a.wvec + 3);
      float su = 0.f, sg = 0.f;
      for (int j = 0; j < m; ++j) {
        const float dg = ur[j] - gain * __ldg(a.goal_u + (size_t)b * m + j);
        su = fmaf(ur[j], ur[j], su);
        sg = fmaf(dg, dg, sg);
      }
      float sd = 0.f;
      for (int i = 0; i < a.gs; ++i) {
        const float d = xs[r * n + i] - __ldg(a.goal + (size_t)b * a.gs + i);
        sd = fmaf(d, d, sd);
      }
      const float ag = a.ag_squared ? a.ag_scale * sg : a.ag_scale * pseudo_huber(sg);
      a.cost[g] = w_u * pseudo_huber(su) + w_x * pseudo_huber(sd) + w_ag * ag;
    }
  }

  // 4. nx = x + MLP([x, u])
  mlp_forward_tile<RM, true>(in, out, wbuf, mlp, stride, a.nx, row0, rows, xs, n);
}

// Dynamic shared memory of one block: two activation tiles and two weight
// chunks of row stride `stride`, and the tile's n-wide states.
template <int RM>
constexpr size_t smem_bytes(int stride, int n) {
  return (2ull * kGroups * RM * stride + 2ull * kChunk * stride + 1ull * kGroups * RM * n) *
         sizeof(float);
}

// Raise the instance's dynamic shared-memory limit to the block's
// maximum, once per device (the attribute call costs host time).
template <int RM>
cudaError_t allow_max_smem(int device) {
  static bool done[kMaxDevices];
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fused_ls_step_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e == cudaSuccess && device < kMaxDevices) done[device] = true;
  return e;
}

template <int RM>
cudaError_t launch(const LsArgs& a, const MlpArgs& mlp, int stride, int device,
                   cudaStream_t stream) {
  constexpr int TM = kGroups * RM;
  const size_t smem = smem_bytes<RM>(stride, a.n);
  if (smem > 48 * 1024) {
    cudaError_t e = allow_max_smem<RM>(device);
    if (e != cudaSuccess) return e;
  }
  const int rows = a.B * a.A;
  const int blocks = (rows + TM - 1) / TM;
  fused_ls_step_kernel<RM><<<blocks, kThreads, smem, stream>>>(a, mlp, stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One forward-scan step (shapes in LsArgs). The dynamics stack is
// n_layers layers of widths dims (dims[0] == n + m, dims[n_layers] == n):
// weights[0] holds W0's n state rows, w0_tail its m action rows, and
// weights[l] (dims[l], dims[l+1]) / biases[l] (dims[l+1]) the rest. All
// pointers are device pointers to contiguous f32. Returns 0 on a
// successful launch, a cudaError_t value if the launch failed, or -1 for
// arguments the kernel does not take.
int fused_ls_step(const float* x3, const float* xref, const float* uref, const float* alpha,
                  const float* k, const float* K, const float* goal, const float* goal_u,
                  const float* wvec, float* nx, float* u, float* cost, int B, int A, int n,
                  int m, int gs, int ag_squared, float ag_scale, int n_layers, const int* dims,
                  const float* const* weights, const float* w0_tail,
                  const float* const* biases, void* stream) {
  if (B < 0 || A < 0 || n < 1 || m < 1 || gs < 0 || gs > n) return -1;
  MlpArgs mlp;
  const int stride = fill_mlp_args(&mlp, n_layers, dims, weights, biases);
  if (stride < 0 || dims[0] != n + m || dims[n_layers] != n) return -1;
  mlp.w0_tail = w0_tail;
  mlp.split = n;
  if ((long long)B * A > 0x7fffffff / (n + m)) return -1;
  const LsArgs a{x3, xref, uref, alpha, k, K, goal, goal_u, wvec, nx, u, cost,
                 B, A, n, m, gs, ag_squared, ag_scale};
  const int rows = B * A;
  if (rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return (int)e;
  // 32-row tiles once there are enough rows for one such block per SM
  // (and their shared memory fits), else 8-row tiles
  if (rows >= sms * kGroups * 4 && smem_bytes<4>(stride, n) <= kMaxSmem) {
    return (int)launch<4>(a, mlp, stride, device, s);
  }
  if (smem_bytes<1>(stride, n) > kMaxSmem) return -1;
  return (int)launch<1>(a, mlp, stride, device, s);
}

}  // extern "C"
