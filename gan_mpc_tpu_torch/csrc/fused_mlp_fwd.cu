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
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or -1 for arguments it refuses).

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

// Raise the instance's dynamic shared-memory limit to the block's
// maximum, once per device: the attribute call costs host time, and the
// planner's launches are bound by host time.
template <int MT, int WM, bool kBf16>
cudaError_t allow_max_smem(int device) {
  static bool done[kMaxDevices];
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_fwd_kernel<MT, WM, kBf16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e == cudaSuccess && device < kMaxDevices) done[device] = true;
  return e;
}

template <int MT, int WM, bool kBf16>
cudaError_t launch(const float* x, float* y, int rows, const TilePlan& plan, const MlpArgs& args,
                   int device, cudaStream_t stream) {
  constexpr int TM = 16 * MT * WM;
  cudaError_t e = allow_max_smem<MT, WM, kBf16>(device);
  if (e != cudaSuccess) return e;
  const int blocks = (rows + TM - 1) / TM;
  fused_mlp_fwd_kernel<MT, WM, kBf16>
      <<<blocks, kBlockThreads, plan.smem, stream>>>(x, y, rows, plan, args);
  return cudaGetLastError();
}

template <bool kBf16>
int dispatch(const float* x, float* y, int rows, const MlpArgs& args, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return (int)e;
  TilePlan plan;
  // 64-row tiles once 16-row tiles would take more than two waves of
  // blocks (where the tile fits and no layer is wider than its warps'
  // 256 columns), else 16-row tiles
  if (rows > 2 * sms * 16 && plan_tile(args, 64, 256, 0, &plan)) {
    return (int)launch<2, 2, kBf16>(x, y, rows, plan, args, device, s);
  }
  if (!plan_tile(args, 16, 512, 0, &plan)) return -1;
  return (int)launch<1, 1, kBf16>(x, y, rows, plan, args, device, s);
}

}  // namespace

extern "C" {

// x (rows, dims[0]) -> y (rows, dims[n_layers]); weights[l] (dims[l],
// dims[l+1]) and biases[l] (dims[l+1]) are device pointers, all f32 and
// contiguous; bf16 != 0 runs the bfloat16 instance. Returns 0 on a
// successful launch, a cudaError_t value if the launch failed, or -1 for
// arguments the kernel does not take.
int fused_mlp_fwd(const float* x, float* y, int rows, int n_layers,
                  const int* dims, const float* const* weights,
                  const float* const* biases, int bf16, void* stream) {
  if (rows < 0) return -1;
  MlpArgs args;
  if (fill_mlp_args(&args, n_layers, dims, weights, biases) < 0) return -1;
  if (rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<true>(x, y, rows, args, s) : dispatch<false>(x, y, rows, args, s);
}

}  // extern "C"
