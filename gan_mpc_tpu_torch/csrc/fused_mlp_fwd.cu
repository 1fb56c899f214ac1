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
// Design (the tile loop itself is in mlp_tile.cuh, shared with
// fused_ls_step.cu):
//  * One block owns a tile of TM rows for the WHOLE stack, activations in
//    shared memory, weights streamed through shared memory in
//    double-buffered cp.async chunks (the TPU kernel keeps every weight
//    resident in VMEM; 354 KB do not fit in a Hopper block's 227 KB).
//  * TM = 8 * RM. RM = 4 (32 rows per block) when there are enough rows
//    for a block per SM (the SM count is read from the device), else
//    RM = 1 (8 rows per block) so that 512 rows still spread over 64 SMs.
//  * The ragged last tile is masked here: rows past `rows` load zeros and
//    are never stored. There is no padding copy.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or -1 for arguments it refuses).

#include "mlp_tile.cuh"

namespace {

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
  mlp_forward_tile<RM, false>(in, out, wbuf, args, stride, y, row0, rows, nullptr, 0);
}

// Dynamic shared memory of one block: two activation tiles of TM rows
// and two weight chunks, all of row stride `stride`.
template <int RM>
constexpr size_t smem_bytes(int stride) {
  return (2ull * kGroups * RM * stride + 2ull * kChunk * stride) * sizeof(float);
}

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
  const size_t smem = smem_bytes<RM>(stride);
  if (smem > 48 * 1024) {
    cudaError_t e = allow_max_smem<RM>(device);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (rows + TM - 1) / TM;
  fused_mlp_fwd_kernel<RM><<<blocks, kThreads, smem, stream>>>(x, y, rows, stride, args);
  return cudaGetLastError();
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
  if (rows < 0) return -1;
  MlpArgs args;
  const int stride = fill_mlp_args(&args, n_layers, dims, weights, biases);
  if (stride < 0) return -1;
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
