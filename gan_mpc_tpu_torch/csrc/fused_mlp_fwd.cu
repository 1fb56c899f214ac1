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
//    through the wide path of mlp_tile_mma.cuh: the same products in
//    passes of 512 (16-row tile) or 256 (64-row tile) columns, separate
//    input and output planes, those planes in a device workspace where
//    they do not fit in shared memory, and the layers read from a table in
//    device memory. One block an SM walks the row tiles. Such a stack takes
//    the 64-row tile where the others would, else the 16-row tile.
//
// The launch uses the caller's stream and allocates nothing: the wide path
// asks the caller for its workspace (fused_mlp_fwd's return value -2) and
// copies the layer table into it. It returns cudaGetLastError() (or -1 for
// arguments it refuses).

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

// The wide path's kernel: the row tiles blockIdx.x, + gridDim.x, ...; the
// block's slot of the workspace holds what plan.planes_smem and
// plan.extra_smem leave out of shared memory.
template <int MT, int WM, bool kBf16>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_mlp_fwd_wide_kernel(const float* __restrict__ x, float* __restrict__ y, int rows,
                          WidePlan plan, MlpTable args, float* slots) {
  constexpr int TM = 16 * MT * WM;
  extern __shared__ __align__(128) unsigned char smem[];
  const WideTile t = carve_wide(smem, plan, TM, slots + blockIdx.x * plan.slot_floats);
  const int tiles = (rows + TM - 1) / TM;
  if (threadIdx.x >= kConsumers) {
    producer_start(t.in.ring);
    ProducerPos pp;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      wide_produce<false>(t.in.ring, pp, args, plan.pass_cols);
    }
    return;
  }
  RingPos pos;
  const int fin = args.layer[0].K, fin8 = (fin + 7) & ~7;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * TM;
    if (tile != (int)blockIdx.x) consumer_sync();  // the last tile's readers are done
    for (int idx = threadIdx.x; idx < TM * fin8; idx += kConsumers) {
      const int r = idx / fin8, k = idx - r * fin8;
      const int g = row0 + r;
      store_act<kBf16>(t.in, act_index(r, k, plan.sa),
                       g < rows && k < fin ? x[(size_t)g * fin + k] : 0.f);
    }
    if (tile == (int)blockIdx.x) {
      consumers_start();
    } else {
      consumer_sync();
    }
    wide_consume<MT, WM, false, kBf16>(t, pos, args, plan, y, row0, rows, nullptr, 0);
  }
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

// The wide path, its layer table and slots in `work` (wide_workspace).
template <int MT, int WM, bool kBf16>
int launch_wide(const float* x, float* y, int rows, int n_layers, const int* dims,
                const float* const* weights, const float* const* biases, int device, int sms,
                void* work, size_t work_bytes, size_t* work_needed, cudaStream_t stream) {
  constexpr int TM = 16 * MT * WM;
  std::vector<LayerDesc> table = layer_table(n_layers, dims, weights, biases, 0);
  WidePlan plan;
  plan_wide(table.data(), n_layers, TM, 8 * kWarpTiles * kConsumerWarps / WM, 0, &plan);
  const int blocks = min((rows + TM - 1) / TM, sms);
  float* slots = nullptr;
  const int err = wide_workspace(table, blocks, plan.slot_floats, work, work_bytes, work_needed,
                                 stream, &slots);
  if (err != 0) return err;
  static bool done[kMaxDevices];
  const cudaError_t e = allow_max_smem(fused_mlp_fwd_wide_kernel<MT, WM, kBf16>, device, done);
  if (e != cudaSuccess) return (int)e;
  const MlpTable args{n_layers, static_cast<const LayerDesc*>(work), nullptr, dims[0]};
  fused_mlp_fwd_wide_kernel<MT, WM, kBf16><<<blocks, kBlockThreads, plan.smem, stream>>>(
      x, y, rows, plan, args, slots);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int dispatch(const float* x, float* y, int rows, int n_layers, const int* dims,
             const float* const* weights, const float* const* biases, void* work,
             size_t work_bytes, size_t* work_needed, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return (int)e;
  // 64-row tiles once 16-row tiles would take more than two waves of
  // blocks (where the tile fits and no layer is wider than its warps'
  // 256 columns), else 16-row tiles; a stack neither takes goes the wide
  // path, at the tile height the same rule picks
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
  return big ? launch_wide<2, 2, kBf16>(x, y, rows, n_layers, dims, weights, biases, device, sms,
                                        work, work_bytes, work_needed, s)
             : launch_wide<1, 1, kBf16>(x, y, rows, n_layers, dims, weights, biases, device, sms,
                                        work, work_bytes, work_needed, s);
}

}  // namespace

extern "C" {

// x (rows, dims[0]) -> y (rows, dims[n_layers]); weights[l] (dims[l],
// dims[l+1]) and biases[l] (dims[l+1]) are device pointers, all f32 and
// contiguous; bf16 != 0 runs the bfloat16 instance. Any depth and widths
// of at least 1. A stack that takes the wide path needs a workspace of
// device memory: where work_bytes is less than it takes, nothing is
// launched and the call returns -2 with the bytes in *work_needed (call
// again with that much). Returns 0 on a successful launch, a cudaError_t
// value if the launch failed, or -1 for arguments that describe no stack.
int fused_mlp_fwd(const float* x, float* y, int rows, int n_layers, const int* dims,
                  const float* const* weights, const float* const* biases, int bf16, void* work,
                  size_t work_bytes, size_t* work_needed, void* stream) {
  if (rows < 0 || stack_width(n_layers, dims) < 0) return -1;
  if (rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<true>(x, y, rows, n_layers, dims, weights, biases, work, work_bytes,
                               work_needed, s)
              : dispatch<false>(x, y, rows, n_layers, dims, weights, biases, work, work_bytes,
                                work_needed, s);
}

}  // extern "C"
