// Three rates of one Hopper SM that the forward kernels' tile loop
// (gan_mpc_tpu_torch/csrc/mlp_tile_mma.cuh) is built around, measured with
// clock64() inside a kernel:
//   1. mma.sync.aligned.m16n8k8 TF32: clocks per product and SM
//      sub-partition, in the loop's pattern (acc[i][j] += a[i] b[j], three
//      times per k-step, operands in distinct registers), alone and with
//      independent integer instructions between the products (do they
//      issue under the products, or beside them?);
//   2. shared-memory loads of 4, 8 and 16 bytes a lane: bytes per clock;
//   3. cp.async.bulk from device memory (L2 after the first pass) into a
//      ring of 4 shared-memory stages: bytes per clock into one SM, with 32
//      and with 128 blocks streaming the same 354 KB at once, as the
//      kernels' blocks stream the flagship's weights.
// Build and run on the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o hopper_rates scripts/hopper_rates.cu
//   ./hopper_rates

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ALU: integer instructions issued after each product, on registers the
// products do not touch.
template <int MT, int T, int ALU = 0>
__global__ void mma_kernel(const float* in, float* out, long long* clk, int iters) {
  uint32_t side[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  float acc[MT][T][4];
  uint32_t ah[MT][4], al[MT][4], bh[T][2], bl[T][2];
  for (int i = 0; i < MT; ++i)
    for (int e = 0; e < 4; ++e) {
      ah[i][e] = __float_as_uint(in[threadIdx.x + 32 * (i * 4 + e)]);
      al[i][e] = __float_as_uint(in[threadIdx.x + 7 + 32 * (i * 4 + e)] * 1e-3f);
    }
  for (int j = 0; j < T; ++j)
    for (int e = 0; e < 2; ++e) {
      bh[j][e] = __float_as_uint(in[threadIdx.x + 999 + 32 * (j * 2 + e)]);
      bl[j][e] = __float_as_uint(in[threadIdx.x + 1999 + 32 * (j * 2 + e)] * 1e-3f);
    }
  for (int i = 0; i < MT; ++i)
    for (int j = 0; j < T; ++j)
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma(acc[i][j], pass == 0 ? al[i] : ah[i], pass == 1 ? bl[j] : bh[j]);
#pragma unroll
          for (int e = 0; e < ALU; ++e) {
            asm volatile("add.u32 %0, %0, 4096;" : "+r"(side[(i + j + e) % 4]));
          }
        }
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = side[0] + side[1] + side[2] + side[3];
  for (int i = 0; i < MT; ++i)
    for (int j = 0; j < T; ++j)
      for (int e = 0; e < 4; ++e) s += acc[i][j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

template <typename V>
__global__ void lds_kernel(float* out, long long* clk, int iters) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < 16384; i += blockDim.x) sm[i] = i;
  __syncthreads();
  const V* p = reinterpret_cast<const V*>(sm) + threadIdx.x;
  float acc = 0.f;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    V v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[(j * 64 + it) & 1023];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += reinterpret_cast<float*>(&v[j])[0];
  }
  __syncthreads();
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread streams `total` bytes in chunks of `chunk` through 4 stages,
// reusing a stage once its copy has landed.
__global__ void bulk_kernel(const float* src, int total, int chunk, long long* clk, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + 128);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 4; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const long long t0 = clock64();
    const int n = total / chunk;
    for (int q = 0; q < n + 4; ++q) {
      const int s = q % 4;
      if (q >= 4) {  // wait for the copy issued four chunks ago
        const uint32_t parity = ((q - 4) / 4) & 1;
        uint32_t done = 0;
        while (!done)
          asm volatile(
              "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
              "selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done)
              : "r"(saddr(bar + s)), "r"(parity)
              : "memory");
      }
      if (q < n) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar + s)),
                     "r"(chunk)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(saddr(buf + s * (chunk / 4))),
            "l"(src + (size_t)q * (chunk / 4)), "r"(chunk), "r"(saddr(bar + s))
            : "memory");
      }
    }
    clk[blockIdx.x] = clock64() - t0;
    out[blockIdx.x] = buf[1];
  }
}

int main() {
  float *in, *out;
  long long* clk;
  cudaMalloc(&in, 1 << 20);
  cudaMalloc(&out, 132 * 1024 * 4);
  cudaMalloc(&clk, 132 * 8);
  static float h[1 << 18];
  for (int i = 0; i < (1 << 18); ++i) h[i] = (float)((i * 2654435761u) % 10007) / 5000.f - 1.f;
  cudaMemcpy(in, h, sizeof(h), cudaMemcpyHostToDevice);
  long long c[132];
  const int iters = 1000;

  auto report_mma = [&](const char* what, int warps, int per_warp) {
    cudaDeviceSynchronize();
    cudaMemcpy(c, clk, sizeof(c), cudaMemcpyDeviceToHost);
    printf("mma.sync m16n8k8 tf32, %s, %d warps a block: %.2f clocks per product and "
           "sub-partition\n", what, warps, (double)c[0] / ((double)iters * per_warp * warps / 4.0));
  };
  for (int rep = 0; rep < 2; ++rep) mma_kernel<2, 4><<<132, 16 * 32>>>(in, out, clk, iters);
  report_mma("2 x 4 tiles a warp", 16, 24);
  for (int rep = 0; rep < 2; ++rep) mma_kernel<1, 2><<<132, 16 * 32>>>(in, out, clk, iters);
  report_mma("1 x 2 tiles a warp", 16, 6);
  for (int rep = 0; rep < 2; ++rep) mma_kernel<1, 1><<<132, 4 * 32>>>(in, out, clk, iters);
  report_mma("1 tile a warp: three products in a chain", 4, 3);
  for (int rep = 0; rep < 2; ++rep) mma_kernel<2, 4, 2><<<132, 16 * 32>>>(in, out, clk, iters);
  report_mma("2 x 4 tiles a warp, 2 integer adds after each product", 16, 24);
  for (int rep = 0; rep < 2; ++rep) mma_kernel<2, 4, 4><<<132, 16 * 32>>>(in, out, clk, iters);
  report_mma("2 x 4 tiles a warp, 4 integer adds after each product", 16, 24);

  cudaFuncSetAttribute(lds_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  cudaFuncSetAttribute(lds_kernel<float2>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  cudaFuncSetAttribute(lds_kernel<float4>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  auto report_lds = [&](int bytes) {
    cudaDeviceSynchronize();
    cudaMemcpy(c, clk, sizeof(c), cudaMemcpyDeviceToHost);
    printf("shared-memory loads of %2d bytes a lane, 16 warps: %.1f bytes per clock and SM\n",
           bytes, 32.0 * bytes * iters * 8 * 16 / (double)c[0]);
  };
  for (int rep = 0; rep < 2; ++rep) lds_kernel<float><<<132, 512, 65536>>>(out, clk, iters);
  report_lds(4);
  for (int rep = 0; rep < 2; ++rep) lds_kernel<float2><<<132, 512, 65536>>>(out, clk, iters);
  report_lds(8);
  for (int rep = 0; rep < 2; ++rep) lds_kernel<float4><<<132, 512, 65536>>>(out, clk, iters);
  report_lds(16);

  const int total = 13 * 25600 + 19200;  // about the flagship dynamics' 354 KB
  cudaFuncSetAttribute(bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 128 + 4 * 51200);
  for (int chunk : {25600, 51200}) {
    for (int blocks : {1, 32, 128}) {
      const int bytes = total / chunk * chunk;
      for (int rep = 0; rep < 3; ++rep)
        bulk_kernel<<<blocks, 32, 128 + 4 * chunk>>>(in, bytes, chunk, clk, out);
      cudaDeviceSynchronize();
      cudaMemcpy(c, clk, sizeof(c), cudaMemcpyDeviceToHost);
      long long worst = 0;
      for (int b = 0; b < blocks; ++b) worst = c[b] > worst ? c[b] : worst;
      printf("cp.async.bulk, %d blocks each streaming %d bytes in %d-byte chunks through 4 "
             "stages: %.1f bytes per clock and SM (slowest block), %lld clocks\n",
             blocks, bytes, chunk, (double)bytes / worst, worst);
    }
  }
  printf("last error: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
