// Fused relu-MLP forward for Hopper (sm_90a): tensor-core products at f32
// accuracy.
//
// Replaces gan_mpc_tpu/ops/fused_mlp.py::_fwd_kernel: for every row,
//   h = x;  h = h @ W_l + b_l  for each layer l,  relu on all but the last.
// Weights are (in, out) row-major, the JAX package's kernel layout. A
// second instance (bf16 = 1) computes mlp_apply(..., dtype=bfloat16),
// h = bf16(h) @ bf16(W_l) + b_l with f32 accumulation (the JAX package's
// _mm, which it runs as plain XLA): the tile loop's bf16 mode, one TF32
// pass on bfloat16-rounded operands (mlp_tile_mma.cuh).
//
// What bounds it on an H100: at the planner's largest call (8192 rows of
// the 23->200->200->200->17 dynamics stack) one call is 1.44 GFLOP of
// products against about 1.3 MB of activations in and out
// (8192 x (23 + 17) x 4 B) plus 354 KB of weights, so the tensor-core
// rate bounds it (three TF32 passes per f32-accurate product: 165 TFLOP/s
// at best), as long as the hidden activations never leave the SM. At 512
// rows and fewer (the rollout, the winner recompute, the trainer's loss)
// the same stack is ~90 MFLOP on at most 32 blocks of 16 rows, each of
// which walks all the weights alone: one SM's product loop over a 16-row
// tile bounds the call (its weight stream from L2 is five times faster).
//
// Design (the tile loop is in mlp_tile_mma.cuh, shared with
// fused_ls_step.cu):
//  * One block owns a tile of rows for the WHOLE stack: 16 consumer warps
//    multiply on the tensor cores (error-compensated TF32, mma.sync
//    m16n8k8) with the activations in shared memory, and a seventeenth
//    warp streams the weights through a 3-4 stage ring of shared memory
//    with bulk copies and mbarriers, across layer boundaries (the TPU
//    kernel keeps every weight resident in VMEM; 354 KB do not fit in a
//    Hopper block's 227 KB).
//  * 64-row tiles (2 x 8 warps of 32 rows x up to 32 columns) once 16-row
//    tiles would take more than two waves of blocks, the tile fits and no
//    layer is wider than 256: 8192 rows are 128 blocks, one wave on 132
//    SMs. Else 16-row tiles (1 x 16 warps), the least an m16 product
//    takes, so that 512 rows spread over 32 SMs.
//  * The ragged last tile is masked here: rows past `rows` load zeros and
//    are never stored. There is no padding copy in device memory.
//  * Any other stack (deeper than kInlineLayers, a layer wider than the
//    tile's warps take in one pass, or activations that do not fit in
//    shared memory: 23->1024^3->17, 23->4096->17, 32 layers of 64) runs
//    through the wide path of mlp_tile_mma.cuh: a cluster of blocks to a
//    row tile, each block a slice of every layer's columns in passes of 512
//    (16-row tile) or 256 (64-row tile), hidden outputs in the blocks'
//    shared memory and read across the cluster as the producer warps stage
//    them beside the weights (past the widths a cluster of 16 holds, in
//    a device workspace), the layers in the launch's parameters. One
//    launch of clusters that walk the row tiles. Such a stack takes the
//    64-row tile where the others would and a cluster of at most 8 holds
//    it, else the 16-row tile.
//
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError() (or -1 for arguments it refuses, -2 where the wide
// path asks for a workspace).

#include "mlp_tile_mma.cuh"

namespace {

template <int MT, int WM, bool kBf16>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ y, int rows,
                     TilePlan plan, MlpArgs args) {
  constexpr int TM = 16 * MT * WM;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tile = carve_tile(smem, plan, TM);
  if (threadIdx.x >= kConsumers) {
    producer_start(tile.ring);
    mlp_produce<false>(tile.ring, args, plan);
    return;
  }

  // the tile's input rows, split (with kBf16 rounded), columns padded
  // with zeros to a multiple of 8
  const int row0 = blockIdx.x * TM;
  const int fin = args.dims[0], fin8 = (fin + 7) & ~7;
  for (int idx = threadIdx.x; idx < TM * fin8; idx += kConsumers) {
    const int r = idx / fin8, k = idx - r * fin8;
    const int g = row0 + r;
    store_act<kBf16>(tile, act_index(r, k, plan.sa),
                     g < rows && k < fin ? x[(size_t)g * fin + k] : 0.f);
  }
  consumers_start();
  mlp_consume<MT, WM, false, kBf16>(tile, args, plan, y, row0, rows, nullptr, 0);
}

// The wide path's kernel: a cluster of plan.cluster blocks a row tile, the
// clusters' tiles cluster_index(), + cluster_count(), ... (mlp_tile_mma.cuh,
// "The wide path of the forward kernels").
template <int MT, int WM, bool kBf16>
__global__ void __launch_bounds__(kWideThreads, 1)
fused_mlp_fwd_wide_kernel(const float* __restrict__ x, float* __restrict__ y, int rows,
                          WidePlan plan, const __grid_constant__ WideTable table) {
  constexpr int TM = 16 * MT * WM;
  extern __shared__ __align__(128) unsigned char smem[];
  const WideTile w = carve_wide(smem, plan, TM, table.acts);
  const int rank = cluster_rank();
  const int tiles = (rows + TM - 1) / TM;
  const int fin = table.layer[0].K;
  int h = 0;  // hidden outputs so far: the buffer of the next is h & 1
  if (threadIdx.x >= kConsumers) {
    wide_producers_start(w.ring);
    int q = 0;
    for (int tile = cluster_index(); tile < tiles; tile += cluster_count()) {
      const int row0 = tile * TM;
      const ActSource x0{x + (size_t)row0 * fin, fin, rows - row0, fin, 0, nullptr, 0, fin};
      wide_produce<TM, false, kBf16>(w.ring, q, plan, table, x0, w.buf, h, rank);
    }
    wide_finish(plan.cluster, false);
    return;
  }
  wide_consumers_start();
  RingPos pos;
  bool pending = false;
  for (int tile = cluster_index(); tile < tiles; tile += cluster_count()) {
    wide_consume<MT, WM, false, kBf16>(w.ring, pos, plan, table, w.buf, h, pending, rank, y,
                                       tile * TM, rows, nullptr, 0);
  }
  wide_finish(plan.cluster, pending);
}

template <int MT, int WM, bool kBf16>
cudaError_t launch(const float* x, float* y, int rows, const TilePlan& plan, const MlpArgs& args,
                   int device, cudaStream_t stream) {
  constexpr int TM = 16 * MT * WM;
  static bool done[kMaxDevices];
  cudaError_t e = allow_max_smem(fused_mlp_fwd_kernel<MT, WM, kBf16>, device, done);
  if (e != cudaSuccess) return e;
  const int blocks = (rows + TM - 1) / TM;
  fused_mlp_fwd_kernel<MT, WM, kBf16>
      <<<blocks, kBlockThreads, plan.smem, stream>>>(x, y, rows, plan, args);
  return cudaGetLastError();
}

// The wide path at 16 * MT * WM rows a tile, on clusters of at most `most`
// blocks (`most` == kMaxCluster: streamed where none holds the stack):
// kNoPlan where no cluster size fits and is placed (the caller tries the
// other tile height), kNeedWorkspace with the bytes in *needed, else 0 or
// a cudaError_t value.
template <int MT, int WM, bool kBf16>
int launch_wide(const float* x, float* y, int rows, int n_layers, const int* dims,
                const float* const* weights, const float* const* biases, int device, int sms,
                int most, void* work, size_t work_bytes, size_t* needed, cudaStream_t stream) {
  constexpr int TM = 16 * MT * WM;
  const auto kernel = fused_mlp_fwd_wide_kernel<MT, WM, kBf16>;
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
  e = plan_launch(kernel, device, placed, layers, TM, false, (rows + TM - 1) / TM, sms, most,
                  most == kMaxCluster, &plan, &clusters);
  if (e != cudaSuccess) return (int)e;
  if (clusters == 0) return kNoPlan;
  WideTable table;
  const int err = wide_table(layers, plan, TM, clusters, nullptr, dims[0], work, work_bytes,
                             needed, stream, &table);
  if (err != 0) return err;
  e = launch_clusters(kernel, TM, plan, clusters, stream, x, y, rows, plan, table);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

template <bool kBf16>
int dispatch(const float* x, float* y, int rows, int n_layers, const int* dims,
             const float* const* weights, const float* const* biases, void* work,
             size_t work_bytes, size_t* needed, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return (int)e;
  // 64-row tiles once 16-row tiles would take more than two waves of
  // blocks (where the tile fits and no layer is wider than its warps'
  // 256 columns), else 16-row tiles; a stack neither takes goes the wide
  // path: at the tile height the same rule picks on clusters of at most 8,
  // else on 16-row tiles and clusters of up to 16
  const bool big = rows > 2 * sms * 16;
  if (n_layers <= kInlineLayers) {
    MlpArgs args;
    fill_mlp_args(&args, n_layers, dims, weights, biases);
    TilePlan plan;
    if (big && plan_tile(args, 64, 256, 0, &plan)) {
      return (int)launch<2, 2, kBf16>(x, y, rows, plan, args, device, s);
    }
    if (plan_tile(args, 16, 512, 0, &plan)) {
      return (int)launch<1, 1, kBf16>(x, y, rows, plan, args, device, s);
    }
  }
  int err = kNoPlan;
  if (big) {
    err = launch_wide<2, 2, kBf16>(x, y, rows, n_layers, dims, weights, biases, device, sms,
                                   kPortableCluster, work, work_bytes, needed, s);
  }
  if (err == kNoPlan) {
    err = launch_wide<1, 1, kBf16>(x, y, rows, n_layers, dims, weights, biases, device, sms,
                                   kMaxCluster, work, work_bytes, needed, s);
  }
  return err == kNoPlan ? -1 : err;
}

}  // namespace

extern "C" {

// x (rows, dims[0]) -> y (rows, dims[n_layers]); weights[l] (dims[l],
// dims[l+1]) and biases[l] (dims[l+1]) are device pointers, all f32 and
// contiguous; bf16 != 0 runs the bfloat16 instance. Any depth and widths
// of at least 1. A stack deeper than kTableLayers, or one with a hidden
// layer too wide for a cluster of 16 to hold (about 18,000 columns: its
// activations stream through device memory), needs a workspace: called
// with fewer bytes than that, the call returns -2 with the bytes in
// *work_needed and launches nothing. Returns 0 on a successful launch, a
// cudaError_t value if the launch failed, or -1 for arguments it refuses
// (no stack).
int fused_mlp_fwd(const float* x, float* y, int rows, int n_layers, const int* dims,
                  const float* const* weights, const float* const* biases, int bf16,
                  void* work, size_t work_bytes, size_t* work_needed, void* stream) {
  *work_needed = 0;
  if (rows < 0 || stack_width(n_layers, dims) < 0) return -1;
  if (rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<true>(x, y, rows, n_layers, dims, weights, biases, work, work_bytes,
                               work_needed, s)
              : dispatch<false>(x, y, rows, n_layers, dims, weights, biases, work, work_bytes,
                                work_needed, s);
}

// The last wide-path launch this library made, into out[5]: the tile's
// rows, the blocks of a cluster, the clusters, the shared memory of a block
// in bytes, 1 for a streamed plan (zeros before the first).
void fused_mlp_fwd_wide_launch(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = last_wide[i];
}

}  // extern "C"
