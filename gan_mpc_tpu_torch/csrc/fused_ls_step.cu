// Fused line-search / rollout step of the batch iLQR solver for Hopper
// (sm_90a): the dynamics MLP on the tensor cores at f32 accuracy.
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
// The bf16 instance (bf16 = 1) is the TPU kernel's bf16 variant: the four
// dots of the MLP (W0's state and action rows, the hidden layers, the
// last layer) take bfloat16 operands with f32 accumulation, the tile
// loop's bf16 mode (one TF32 pass on bfloat16-rounded operands,
// mlp_tile_mma.cuh); the control law, the stage cost, the residual add and
// every output stay f32, as in the TPU kernel.
//
// What bounds it on an H100: at the line search's call (512 lanes x 16
// step sizes = 8192 rows, 23->200->200->200->17 dynamics) the MLP is
// 2 x 8192 x 88,000 = 1.44 GFLOP of products against about 2 MB of
// inputs, outputs and weights, so the tensor-core rate bounds it (three
// TF32 passes per f32-accurate product: 165 TFLOP/s at best), not device
// memory. The control law and the cost add under 1% of the operations
// and stay on the f32 pipes. At 512 rows (the rollout and the winner
// recompute, A = 1) each of the 32 blocks of 16 rows walks all the weights
// alone, and one SM's product loop over a 16-row tile bounds the call (its
// weight stream from L2 is five times faster).
//
// Design:
//  * One block owns a tile of rows. Its seventeenth warp starts streaming
//    the dynamics weights into the shared-memory ring at once (bulk
//    copies, mbarriers; W0's two tensors are two spans of the first
//    chunk), while the 16 consumer warps load the tile's states into
//    shared memory and form u there (one thread per row and action; the
//    lane's Xref, Uref, k and K rows are read through the read-only
//    cache, shared by the A rows of a lane). Then the consumers run the
//    dynamics MLP on [x, u] with the tile loop of mlp_tile_mma.cuh
//    (error-compensated TF32 on mma.sync m16n8k8, activations in shared
//    memory as a hi and a lo plane), the last warps after they have
//    written the stage cost from the f32 rows. The last layer's epilogue
//    adds the kept input state, so nx = x + MLP([x, u]) leaves the block
//    in one store.
//  * The state term of the cost uses the INPUT x, not nx.
//  * 64-row tiles once 16-row tiles would take more than two waves of
//    blocks, the tile fits and no layer is wider than 256 (8192 rows: 128
//    blocks, one wave), else 16-row tiles, so that the 512-row calls
//    spread over 32 SMs.
//  * The ragged last tile is masked: rows past B * A load zeros and are
//    never stored.
//  * Any other dynamics stack (deeper than kInlineLayers, wider than the
//    tile's warps take in one pass, or too wide for shared memory) runs the
//    same control law and cost and the wide path of mlp_tile_mma.cuh for the
//    MLP, as fused_mlp_fwd.cu does: a cluster of blocks to a row tile,
//    block 0 of the cluster writing u and the cost, every block's producers
//    staging the first layer's input [x, u] from x3 and u in device memory;
//    W0's two tensors are the two sources of each weight row.
//
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError() (or -1 for arguments it refuses, -2 where the wide
// path asks for a workspace, as fused_mlp_fwd.cu's).

#include "mlp_tile_mma.cuh"

namespace {

constexpr float kHuberAlpha = 1e-2f;  // models/cost.py _HUBER_ALPHA

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

// Steps 1-2 for the tile of TM rows from row0: the tile's states into the
// f32 rows xu (TM x (n + m)), the control law into xu's u columns and a.u.
// Rows past B * A are zeros.
template <int TM>
__device__ __forceinline__ void ls_control(const LsArgs& a, float* xu, int row0) {
  const int rows = a.B * a.A;
  const int n = a.n, m = a.m, nm = n + m;

  // 1. the tile's states
  for (int idx = threadIdx.x; idx < TM * n; idx += kConsumers) {
    const int r = idx / n, c = idx - r * n;
    const int g = row0 + r;
    xu[r * nm + c] = g < rows ? a.x3[(size_t)g * n + c] : 0.f;
  }
  consumer_sync();

  // 2. control law, one thread per (row, action)
  for (int idx = threadIdx.x; idx < TM * m; idx += kConsumers) {
    const int r = idx / m, j = idx - r * m;
    const int g = row0 + r;
    float uj = 0.f;
    if (g < rows) {
      const int b = g / a.A;
      const float* Kj = a.K + ((size_t)b * m + j) * n;
      const float* xr = a.xref + (size_t)b * n;
      float du = 0.f;
      // unrolled so that a batch of the loop's loads is in flight at once
#pragma unroll 8
      for (int i = 0; i < n; ++i) du = fmaf(__ldg(Kj + i), xu[r * nm + i] - __ldg(xr + i), du);
      uj = __ldg(a.uref + (size_t)b * m + j) + __ldg(a.alpha + g) * __ldg(a.k + (size_t)b * m + j)
           + du;
      a.u[(size_t)g * m + j] = uj;
    }
    xu[r * nm + n + j] = uj;
  }
  consumer_sync();
}

// Step 2 on the wide path: the control law for the tile of TM rows from
// row0 into a.u, the states read from x3 (the same sums as ls_control's).
template <int TM>
__device__ __forceinline__ void ls_control_rows(const LsArgs& a, int row0) {
  const int rows = a.B * a.A;
  const int n = a.n, m = a.m;
  for (int idx = threadIdx.x; idx < TM * m; idx += kConsumers) {
    const int r = idx / m, j = idx - r * m;
    const int g = row0 + r;
    if (g >= rows) continue;
    const int b = g / a.A;
    const float* Kj = a.K + ((size_t)b * m + j) * n;
    const float* xr = a.xref + (size_t)b * n;
    const float* xg = a.x3 + (size_t)g * n;
    float du = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) du = fmaf(__ldg(Kj + i), __ldg(xg + i) - __ldg(xr + i), du);
    a.u[(size_t)g * m + j] =
        __ldg(a.uref + (size_t)b * m + j) + __ldg(a.alpha + g) * __ldg(a.k + (size_t)b * m + j) + du;
  }
}

// Steps 1-3 for the tile of TM rows from row0: ls_control into tile.extra,
// then the MLP's input tile [x, u] into the planes, split (with kBf16
// rounded), padded with zeros to a multiple of 8 columns.
template <int TM, bool kBf16>
__device__ __forceinline__ void ls_inputs(const LsArgs& a, const Tile& tile, int sa, int row0) {
  float* xu = tile.extra;  // TM x (n + m): the MLP's input rows [x, u] in f32
  ls_control<TM>(a, xu, row0);

  // 3. the MLP's input tile: [x, u], split (with kBf16 rounded), padded
  // with zeros to a multiple of 8 columns
  const int nm = a.n + a.m, nm8 = (nm + 7) & ~7;
  for (int idx = threadIdx.x; idx < TM * nm8; idx += kConsumers) {
    const int r = idx / nm8, c = idx - r * nm8;
    store_act<kBf16>(tile, act_index(r, c, sa), c < nm ? xu[r * nm + c] : 0.f);
  }
}

// Step 4, the stage cost, one thread per row, from the f32 rows xu. The
// last warps take it: theirs are the column groups a layer leaves without
// tiles first, and the others start on the products meanwhile.
// The tile's f32 rows: x at xs + r * x_ld, u at us + r * u_ld.
template <int TM>
__device__ __forceinline__ void ls_cost(const LsArgs& a, const float* xs, int x_ld,
                                        const float* us, int u_ld, int row0) {
  if (threadIdx.x < kConsumers - TM) return;
  const int rows = a.B * a.A;
  const int m = a.m;
  const int r = threadIdx.x - (kConsumers - TM);
  const int g = row0 + r;
  if (g < rows) {
    const int b = g / a.A;
    const float* ur = us + r * u_ld;
    const float w_u = __ldg(a.wvec), w_x = __ldg(a.wvec + 1);
    const float w_ag = __ldg(a.wvec + 2), gain = __ldg(a.wvec + 3);
    float su = 0.f, sg = 0.f;
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const float dg = ur[j] - gain * __ldg(a.goal_u + (size_t)b * m + j);
      su = fmaf(ur[j], ur[j], su);
      sg = fmaf(dg, dg, sg);
    }
    float sd = 0.f;
#pragma unroll 8
    for (int i = 0; i < a.gs; ++i) {
      const float d = xs[r * x_ld + i] - __ldg(a.goal + (size_t)b * a.gs + i);
      sd = fmaf(d, d, sd);
    }
    const float ag = a.ag_squared ? a.ag_scale * sg : a.ag_scale * pseudo_huber(sg);
    a.cost[g] = w_u * pseudo_huber(su) + w_x * pseudo_huber(sd) + w_ag * ag;
  }
}

template <int MT, int WM, bool kBf16>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_ls_step_kernel(LsArgs a, MlpArgs mlp, TilePlan plan) {
  constexpr int TM = 16 * MT * WM;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tile = carve_tile(smem, plan, TM);
  if (threadIdx.x >= kConsumers) {
    producer_start(tile.ring);
    mlp_produce<true>(tile.ring, mlp, plan);
    return;
  }
  const int row0 = blockIdx.x * TM;
  ls_inputs<TM, kBf16>(a, tile, plan.sa, row0);
  consumers_start();
  ls_cost<TM>(a, tile.extra, a.n + a.m, tile.extra + a.n, a.n + a.m, row0);
  // 5. nx = x + MLP([x, u])
  mlp_consume<MT, WM, true, kBf16>(tile, mlp, plan, a.nx, row0, a.B * a.A, tile.extra, a.n + a.m);
}

// The wide path's kernel: a cluster of plan.cluster blocks a row tile, the
// clusters' tiles cluster_index(), + cluster_count(), ... (mlp_tile_mma.cuh,
// "The wide path of the forward kernels"). Block 0 of the cluster writes
// the tile's u (the control law) and stage cost; every block's producers
// then stage the first layer's input [x, u] from x3 and u in device memory
// (the wait at the layer barrier, as for a hidden output), and its last
// layer adds the residual x from x3: the inputs take no shared memory,
// whatever n + m.
template <int MT, int WM, bool kBf16>
__global__ void __launch_bounds__(kWideThreads, 1)
fused_ls_step_wide_kernel(LsArgs a, WidePlan plan, const __grid_constant__ WideTable table) {
  constexpr int TM = 16 * MT * WM;
  extern __shared__ __align__(128) unsigned char smem[];
  const WideTile w = carve_wide(smem, plan, TM, table.acts);
  const int rank = cluster_rank();
  const int rows = a.B * a.A, n = a.n, m = a.m;
  const int tiles = (rows + TM - 1) / TM;
  int h = 0;  // hidden outputs so far: the buffer of the next is h & 1
  if (threadIdx.x >= kConsumers) {
    wide_producers_start(w.ring);
    int q = 0;
    for (int tile = cluster_index(); tile < tiles; tile += cluster_count()) {
      const int row0 = tile * TM;
      const ActSource xu{a.x3 + (size_t)row0 * n, n, rows - row0, n + m, 0,
                         a.u + (size_t)row0 * m, m, n};
      wide_produce<TM, true, kBf16>(w.ring, q, plan, table, xu, w.buf, h, rank);
    }
    wide_finish(plan.cluster, false);
    return;
  }
  wide_consumers_start();
  RingPos pos;
  bool pending = false;
  for (int tile = cluster_index(); tile < tiles; tile += cluster_count()) {
    const int row0 = tile * TM;
    if (rank == 0) {
      ls_control_rows<TM>(a, row0);
      consumer_sync();  // u whole before the cost reads it
    }
    hidden_written(plan.cluster, pending);  // the first layer's input: u is written
    if (rank == 0) {
      ls_cost<TM>(a, a.x3 + (size_t)row0 * n, n, a.u + (size_t)row0 * m, m, row0);
    }
    wide_consume<MT, WM, true, kBf16>(w.ring, pos, plan, table, w.buf, h, pending, rank, a.nx,
                                      row0, rows, a.x3 + (size_t)row0 * n, n);
  }
  wide_finish(plan.cluster, pending);
}

template <int MT, int WM, bool kBf16>
cudaError_t launch(const LsArgs& a, const MlpArgs& mlp, const TilePlan& plan, int device,
                   cudaStream_t stream) {
  constexpr int TM = 16 * MT * WM;
  static bool done[kMaxDevices];
  cudaError_t e = allow_max_smem(fused_ls_step_kernel<MT, WM, kBf16>, device, done);
  if (e != cudaSuccess) return e;
  const int rows = a.B * a.A;
  const int blocks = (rows + TM - 1) / TM;
  fused_ls_step_kernel<MT, WM, kBf16><<<blocks, kBlockThreads, plan.smem, stream>>>(a, mlp, plan);
  return cudaGetLastError();
}

// The wide path at 16 * MT * WM rows a tile, on clusters of at most `most`
// blocks: kNoPlan, kNeedWorkspace, 0 or a cudaError_t value (as
// fused_mlp_fwd.cu's).
template <int MT, int WM, bool kBf16>
int launch_wide(const LsArgs& a, int n_layers, const int* dims, const float* const* weights,
                const float* w0_tail, const float* const* biases, int device, int sms, int most,
                void* work, size_t work_bytes, size_t* needed, cudaStream_t stream) {
  constexpr int TM = 16 * MT * WM;
  const auto kernel = fused_ls_step_wide_kernel<MT, WM, kBf16>;
  static bool done[kMaxDevices];
  static int placed[kMaxDevices][5];
  cudaError_t e = allow_wide(kernel, device, done);
  if (e != cudaSuccess) return (int)e;
  std::vector<WideLayer> layers(n_layers);
  for (int l = 0; l < n_layers; ++l) {
    layers[l] = WideLayer{weights[l], biases[l], dims[l], dims[l + 1], 0, 0};
  }
  WidePlan plan;
  int clusters = 0;
  e = plan_launch(kernel, device, placed, layers, TM, true, (a.B * a.A + TM - 1) / TM, sms, most,
                  most == kMaxCluster, &plan, &clusters);
  if (e != cudaSuccess) return (int)e;
  if (clusters == 0) return kNoPlan;
  WideTable table;
  const int err = wide_table(layers, plan, TM, clusters, w0_tail, a.n, work, work_bytes, needed,
                             stream, &table);
  if (err != 0) return err;
  e = launch_clusters(kernel, TM, plan, clusters, stream, a, plan, table);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

template <bool kBf16>
int dispatch(const LsArgs& a, int n_layers, const int* dims, const float* const* weights,
             const float* w0_tail, const float* const* biases, void* work, size_t work_bytes,
             size_t* needed, cudaStream_t s) {
  const int rows = a.B * a.A, nm = a.n + a.m;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return (int)e;
  // 64-row tiles once 16-row tiles would take more than two waves of
  // blocks (where the tile with its f32 input rows fits and no layer is
  // wider than its warps' 256 columns), else 16-row tiles; a stack neither
  // takes goes the wide path, as fused_mlp_fwd.cu's dispatch sends it
  const bool big = rows > 2 * sms * 16;
  if (n_layers <= kInlineLayers) {
    MlpArgs mlp;
    fill_mlp_args(&mlp, n_layers, dims, weights, biases);
    mlp.w0_tail = w0_tail;
    mlp.split = a.n;
    TilePlan plan;
    if (big && plan_tile(mlp, 64, 256, 64 * nm, &plan)) {
      return (int)launch<2, 2, kBf16>(a, mlp, plan, device, s);
    }
    if (plan_tile(mlp, 16, 512, 16 * nm, &plan)) {
      return (int)launch<1, 1, kBf16>(a, mlp, plan, device, s);
    }
  }
  int err = kNoPlan;
  if (big) {
    err = launch_wide<2, 2, kBf16>(a, n_layers, dims, weights, w0_tail, biases, device, sms,
                                   kPortableCluster, work, work_bytes, needed, s);
  }
  if (err == kNoPlan) {
    err = launch_wide<1, 1, kBf16>(a, n_layers, dims, weights, w0_tail, biases, device, sms,
                                   kMaxCluster, work, work_bytes, needed, s);
  }
  return err == kNoPlan ? -1 : err;
}

}  // namespace

extern "C" {

// One forward-scan step (shapes in LsArgs). The dynamics stack is
// n_layers layers of widths dims (dims[0] == n + m, dims[n_layers] == n):
// weights[0] holds W0's n state rows, w0_tail its m action rows, and
// weights[l] (dims[l], dims[l+1]) / biases[l] (dims[l+1]) the rest. Any
// depth and hidden widths of at least 1, as fused_mlp_fwd takes them, and
// a workspace where fused_mlp_fwd would ask for one (-2, the bytes in
// *work_needed). All pointers are device pointers to contiguous f32; bf16
// != 0 runs the bfloat16 instance. Returns 0 on a successful launch, a
// cudaError_t value if the launch failed, or -1 for arguments it refuses.
int fused_ls_step(const float* x3, const float* xref, const float* uref, const float* alpha,
                  const float* k, const float* K, const float* goal, const float* goal_u,
                  const float* wvec, float* nx, float* u, float* cost, int B, int A, int n,
                  int m, int gs, int ag_squared, float ag_scale, int n_layers, const int* dims,
                  const float* const* weights, const float* w0_tail,
                  const float* const* biases, int bf16, void* work, size_t work_bytes,
                  size_t* work_needed, void* stream) {
  *work_needed = 0;
  if (B < 0 || A < 0 || n < 1 || m < 1 || gs < 0 || gs > n) return -1;
  if (stack_width(n_layers, dims) < 0) return -1;
  if (dims[0] != n + m || dims[n_layers] != n) return -1;
  if ((long long)B * A > 0x7fffffff / (n + m)) return -1;
  const LsArgs a{x3, xref, uref, alpha, k, K, goal, goal_u, wvec, nx, u, cost,
                 B, A, n, m, gs, ag_squared, ag_scale};
  if (B * A == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<true>(a, n_layers, dims, weights, w0_tail, biases, work, work_bytes,
                               work_needed, s)
              : dispatch<false>(a, n_layers, dims, weights, w0_tail, biases, work, work_bytes,
                                work_needed, s);
}

// The last wide-path launch this library made, into out[5]: the tile's
// rows, the blocks of a cluster, the clusters, the shared memory of a block
// in bytes, 1 for a streamed plan (zeros before the first).
void fused_ls_step_wide_launch(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = last_wide[i];
}

}  // extern "C"
