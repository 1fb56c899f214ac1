// The forward kernels' product loop (chunk_products of
// gan_mpc_tpu_torch/csrc/mlp_tile_mma.cuh) alone: 16 warps of one block
// multiply a resident activation tile by resident weights, with no ring,
// no barrier and no epilogue, and clock64() gives the clocks per k-step
// (8 weight rows). Beside it stands what mma.sync alone would take for
// the same products (6.03 clocks each per sub-partition,
// scripts/hopper_rates.cu). The difference between this loop's time and
// the kernels' time per k-step is what the ring, the barriers and the
// epilogues cost. Build and run on the card, from the repository's root:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o mlp_loop_rate scripts/mlp_loop_rate.cu && ./mlp_loop_rate

#include "../gan_mpc_tpu_torch/csrc/mlp_tile_mma.cuh"

#include <cstdio>

// MT 16-row blocks x T tiles a warp; N columns, K weight rows a pass.
template <int MT, int T>
__global__ void loop_kernel(float* out, long long* clk, int reps, int N, int K, int sa) {
  extern __shared__ __align__(128) float sm[];
  const int plane = 16 * MT * 2 * sa;  // two row groups of 16 * MT rows
  float* hi = sm;
  float* lo = sm + plane;
  float* w = lo + plane;
  for (int i = threadIdx.x; i < 2 * plane + K * N; i += blockDim.x) sm[i] = 1.f + (i % 97) * 0.01f;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int wm = warp % 2, wn = warp / 2;
  const int base = (wn * T * 8) % (N - 8 * T);
  const int a_at = act_index(wm * MT * 16 + g, t, sa);
  float acc[MT][T][4] = {};
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    chunk_products<MT, T, true>(acc, hi + a_at, lo + a_at, sa, w + t * N + base + g * T, N, K);
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < MT; ++i)
    for (int j = 0; j < T; ++j)
      for (int e = 0; e < 4; ++e) s += acc[i][j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

template <int MT, int T>
void run(const char* what, int K) {
  float* out;
  long long* clk;
  cudaMalloc(&out, 32 * 512 * 4);
  cudaMalloc(&clk, 32 * 8);
  const int N = 200, sa = 204, reps = 20000 / K;
  const size_t smem = (4 * 16 * MT * sa + K * N) * sizeof(float);
  cudaFuncSetAttribute(loop_kernel<MT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  for (int i = 0; i < 2; ++i) loop_kernel<MT, T><<<32, 512, smem>>>(out, clk, reps, N, K, sa);
  cudaDeviceSynchronize();
  long long c;
  cudaMemcpy(&c, clk, 8, cudaMemcpyDeviceToHost);
  const double per_step = (double)c / (reps * (K / 8));
  const double floor_clk = 6.03 * MT * T * 3 * 16 / 4;
  printf("%s: %.1f clocks per k-step, mma.sync alone %.1f (%.0f%%) (%s)\n", what, per_step,
         floor_clk, 100.0 * floor_clk / per_step, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  run<1, 2>("16-row tile's loop, 1 x 2 tiles a warp, 200 weight rows a pass", 200);
  run<1, 2>("16-row tile's loop, 1 x 2 tiles a warp, 64 weight rows a pass", 64);
  run<2, 4>("64-row tile's loop, 2 x 4 tiles a warp, 32 weight rows a pass", 32);
  run<2, 4>("64-row tile's loop, 2 x 4 tiles a warp, 64 weight rows a pass", 64);
  return 0;
}
