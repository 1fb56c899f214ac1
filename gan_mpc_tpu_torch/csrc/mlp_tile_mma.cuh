// The tile loop of the fused-MLP kernels: a relu-MLP forward over one tile
// of rows on Hopper's tensor cores, at f32 accuracy, for the two forward
// kernels (fused_mlp_fwd.cu and fused_ls_step.cu) and for the recompute of
// the backward kernel (fused_mlp_bwd.cu), whose dx chain and dW use the
// same products, fragments and weight ring (its header says how). It
// stands where the TPU kernels (gan_mpc_tpu/ops/fused_mlp.py::_fwd_kernel,
// ::_bwd_kernel and the MLP part of gan_mpc_tpu/ops/fused_ls.py::_kernel)
// run jnp.dot(..., preferred_element_type=f32) on the matrix unit.
//
// What bounds the loop on an H100. At the planner's large call (8192 rows
// of 23->200->200->200->17) the products are 1.44 GFLOP against 1.7 MB of
// rows and weights, so the tensor-core rate bounds it: an f32-accurate
// product costs three TF32 passes, 495 / 3 = 165 TFLOP/s at best (mma.sync
// issues one m16n8k8 per 6 clocks and SM sub-partition, 63% of that). At
// 512 rows and fewer the call is a few blocks (16 rows is the least an
// m16 product takes: 32 blocks at 512 rows), and each walks the whole
// stack alone: 75 k-steps of 8 weight rows in which a warp has two output
// tiles, so three dependent products per tile and k-step, and one SM's
// product loop at that depth (about 250 clocks a k-step) bounds the call.
// The weight stream does not: one SM pulls the stack's 354 KB from L2 at
// 80-odd bytes a clock, a fifth of the loop's time, so the ring only has
// to stay ahead (both rates: scripts/hopper_rates.cu, mlp_loop_rate.cu).
//
// Design.
//  * Products: mma.sync.aligned.m16n8k8 (TF32 in, f32 accumulate), three
//    per output tile and k-step. Each f32 operand v is split into hi =
//    tf32(v) and lo = tf32(v - hi), both rounded to nearest, and the
//    accumulator takes a_lo w_hi + a_hi w_lo + a_hi w_hi; the dropped
//    a_lo w_lo term is 2^-22 of the product. A single TF32 pass would keep
//    three decimal digits and flip line-search argmins. The rounding is
//    two integer instructions (add half an ulp, mask 13 bits: ties away
//    from zero, what cvt.rna.tf32.f32 gives, without the conversion
//    unit). Activations are split once, when they are written: the tile
//    is a hi plane and a lo plane, so an A fragment costs loads and no
//    arithmetic. Weights are split in registers as they are read from the
//    ring, once per warp row group.
//    mma.sync and not wgmma: its fragments are plain shared-memory loads,
//    so the (in, out) row-major weights are used as they lie (B[k][n] at
//    k * N + n) and rows tile by 16; wgmma's TF32 form takes both
//    operands K-major, so W would have to be transposed on its way into
//    shared memory.
//  * Tile: 16 consumer warps own TM = 16 * MT * WM rows for the WHOLE
//    stack, as WM row groups x WN = 16 / WM column groups: four warps a
//    sub-partition, so one warp's loads and splits run under another's
//    products. A warp keeps MT 16-row blocks x up to 4 8-column tiles of
//    accumulators in registers. A layer's tiles are dealt to the column
//    groups in runs of ceil(tiles / WN): 200 columns are runs of 4 on 7 of
//    the 8 groups of the 64-row tile, and the 17-column last layer one
//    tile each on 3 groups, not 3 tiles on one. So one pass of the loop
//    covers at most 32 * WN columns: 256 for the 64-row tile (2 x 8
//    warps), 512 for the 16-row tile (1 x 16). A wider layer takes the wide
//    path, in passes of that many columns (below).
//  * Fragment layout, chosen so that loads are wide and land in the
//    registers the product reads them from. A warp's tiles lie side by
//    side and share their columns out by lane (column n of tile j is
//    column base + n * T + j), so a lane's T weights of one row are
//    neighbours: one 16-byte load for 4 tiles, and no bank conflict at a
//    row length = 8 (mod 32) floats, which 200 is (128 and 256 take a
//    4-way conflict; copying them row by row at a padded stride cost more
//    than it saved). In the activation planes rows r and r + 8 are
//    interleaved element by element (act_index), so a fragment's two rows
//    of a column are one 8-byte load; the row-pair stride 2 * sa = 8 (mod
//    16) floats keeps those loads off each other's banks. The plane is
//    overwritten in place, between two barriers of the consumer warps, by
//    each layer's output, 4 T neighbouring floats a lane; no hidden
//    activation touches device memory. The bias is fetched when a layer
//    starts and added in the epilogue, so its load latency hides behind
//    the products; relu, the split and the store (for the last layer to
//    device memory, masked for the ragged tile, plus the residual for the
//    step kernel) come from registers.
//  * Weights: a seventeenth warp streams them through a ring of 3-4
//    stages of shared memory with cp.async.bulk (no tensor map). A chunk
//    of weight rows of a row-major matrix is one contiguous span, so one
//    lane issues it as one copy; a full/empty mbarrier pair per stage
//    replaces block-wide barriers, and the ring runs across layer
//    boundaries: the next layer's first chunks are in flight during this
//    layer's epilogue. Chunks start at multiples of 8 rows, so every span
//    starts 16-byte aligned whenever the matrix does; the under-16-byte
//    end of a span, a matrix that is not 16-byte aligned, and the zero
//    rows that pad K to a multiple of 8 are written by the warp's plain
//    stores, after the copy is on its way. The block's first chunk lands
//    before the others are issued, so that it does not share the SM's copy
//    rate with them. Weights are read from device memory anew at every
//    launch (the optimizer updates them in place).
//  * The bf16 mode (kBf16, the TPU kernels' bfloat16 compute dtype):
//    every operand is rounded to bfloat16, to nearest with ties to even
//    (what astype(jnp.bfloat16) does), where it is loaded: the activations
//    when they are written to the hi plane (an f32 whose low half is
//    zero), the weights as they are read from the ring, which carries the
//    f32 weights unchanged. The products are bf16 tensor-core products,
//    mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate): what
//    jnp.dot(a.astype(bf16), w.astype(bf16), preferred_element_type=f32)
//    computes on the matrix unit. One product covers two of the f32
//    mode's k-steps: the fragment's k pairs (2t, 2t + 1) and (2t + 8,
//    2t + 9) are taken to be the columns (t, t + 8) and (t + 4, t + 12)
//    of the two steps, the same permutation of k on both operands (a sum
//    over k does not see it), so a lane loads from the hi plane and the
//    ring exactly what it loads for two TF32 steps and packs pairs into
//    bf16x2 words: the activations by a byte permute, the weights by one
//    cvt.rn.bf16x2.f32. An odd last step of 8 takes zeros for its second
//    half. The lo plane is neither written nor read (the shared-memory plan
//    keeps its place, so both modes share it). Designs that stored the
//    operands as bfloat16 in shared memory, with the weights rounded once
//    per block, lost to this one on the 200-wide stacks that the bf16 paths
//    run: the block's f32 weight stream through shared memory bounds the
//    loop, not its products (PERF.md, section 6). Measured against the one
//    TF32 pass this replaces (NVIDIA H100 80GB HBM3, 700 W;
//    scripts/time_torch_kernels.py --trees): the dynamics stack at 8192
//    rows 0.0190 ms for 0.0220 (its bound at 989 TFLOP/s dense bf16 is
//    0.00146 ms, 7.7% of it), at 512 rows 0.0107 for 0.0124, the line-search
//    step at 512 x 16 0.0231 for 0.0249, at 512 x 1 0.0131 for 0.0145.
//  * Widths that are no multiple of 8 are padded in shared memory only:
//    input columns and weight rows with zeros; columns past a layer's
//    width compute on whatever the stage holds and are written as zeros.
//
// Everything here sits in an anonymous namespace: each kernel source
// builds into a library of its own.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstring>

#include "mlp_tile.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kConsumerWarps = 16;
constexpr int kConsumers = kConsumerWarps * kWarp;  // the threads that multiply
constexpr int kBlockThreads = kConsumers + kWarp;   // ... and the producer warp
constexpr int kWarpTiles = 4;                       // 8-column tiles per warp, at most
constexpr int kMaxStages = 4;
constexpr int kMinStages = 3;
constexpr size_t kMaxSmem = 232448;                 // a Hopper block's dynamic shared memory
constexpr size_t kBarrierBytes = 128;               // 2 * kMaxStages mbarriers, padded
constexpr int kOutSegments = 2;   // layer_tiles' kOut on the backward's wide recompute
constexpr int kSegmentRows = 512;  // ... whose contraction runs in segments of these rows of K

// Raise a kernel's dynamic shared-memory limit to the block's maximum, once
// per device (`done`: the instance's flags): the attribute call costs host
// time, and the planner's launches are bound by host time.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, int device, bool* done) {
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e == cudaSuccess && device < kMaxDevices) done[device] = true;
  return e;
}

// A block's shared memory: [mbarriers][hi plane][lo plane][extra][ring + 8].
struct TilePlan {
  int sa;                // activation row stride, floats: = 4 (mod 8)
  int extra_floats;      // the caller's own buffer
  int stage_floats;      // floats per ring stage
  int stages;
  int step[kInlineLayers];  // weight rows per chunk of layer l: what a stage holds, in whole
                           // k-steps of 8
  size_t smem;           // bytes
};

// Size the ring for `tile_rows` rows whose warps take layers of up to
// `max_cols` columns: the deepest of 64-, 32-, 16- or 8-row stages (at
// the stack's widest layer) of which at least kMinStages fit.
inline bool plan_tile(const MlpArgs& a, int tile_rows, int max_cols, int extra_floats,
                      TilePlan* p) {
  int widest = 0, widest_out = 0;
  for (int l = 0; l <= a.n_layers; ++l) widest = max(widest, a.dims[l]);
  for (int l = 1; l <= a.n_layers; ++l) widest_out = max(widest_out, a.dims[l]);
  if (widest_out > max_cols) return false;
  p->sa = ((widest + 7) & ~7) + 4;
  p->extra_floats = (extra_floats + 3) & ~3;
  const size_t fixed =
      kBarrierBytes + (2ull * tile_rows * p->sa + p->extra_floats + 8) * sizeof(float);
  for (int rows = 64; rows >= 8; rows /= 2) {
    p->stage_floats = rows * ((widest_out + 3) & ~3);
    const size_t stage = p->stage_floats * sizeof(float);
    if (fixed + kMinStages * stage > kMaxSmem) continue;
    p->stages = (int)min((size_t)kMaxStages, (kMaxSmem - fixed) / stage);
    p->smem = fixed + p->stages * stage;
    for (int l = 0; l < a.n_layers; ++l) p->step[l] = (p->stage_floats / a.dims[l + 1]) & ~7;
    return true;
  }
  return false;
}

struct Ring {
  float* buf;        // stages x stage_floats (+ 8 floats a fragment may read past the end)
  uint64_t* full;    // [stages]: the stage's rows have landed
  uint64_t* empty;   // [stages]: every consumer warp has read the stage
  int stage_floats;
  int stages;
};

struct Tile {
  float* hi;  // tile_rows x sa: the activations' TF32 parts, laid out by act_index
  float* lo;  // tile_rows x sa: what the TF32 parts leave, in TF32
  float* extra;
  Ring ring;
};

// Where row r, column c of the tile lies in a plane: rows r and r + 8 of a
// 16-row block are interleaved element by element, so that an A
// fragment's two rows of one column come with one 8-byte load, into the
// neighbouring registers the product reads them from.
__device__ __forceinline__ int act_index(int r, int c, int sa) {
  return ((r >> 4) * 8 + (r & 7)) * 2 * sa + 2 * c + ((r >> 3) & 1);
}

__device__ __forceinline__ Tile carve_tile(unsigned char* smem, const TilePlan& p, int tile_rows) {
  Tile t;
  t.ring.full = reinterpret_cast<uint64_t*>(smem);
  t.ring.empty = t.ring.full + kMaxStages;
  t.hi = reinterpret_cast<float*>(smem + kBarrierBytes);
  t.lo = t.hi + tile_rows * p.sa;
  t.extra = t.lo + tile_rows * p.sa;
  t.ring.buf = t.extra + p.extra_floats;
  t.ring.stage_floats = p.stage_floats;
  t.ring.stages = p.stages;
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier has left the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_wait for the wide path, whose producer warp issues many copies a
// stage: the waiting thread is suspended until the phase completes (or the
// hint's time passes) instead of spinning, which would take the issue slots
// and shared-memory pipe that the producer's copies need.
__device__ __forceinline__ void mbar_wait_suspend(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity), "r"(0x989680u)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory; its completion counts `bytes` on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A barrier of the consumer warps alone: the producer warp never joins.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The block's start. The producer warp sets up the ring's barriers (a
// stage is full after the producer's two arrivals, one with the byte
// count of its bulk copies and one after its plain stores, and empty
// after one arrival per consumer warp), tells the consumers without
// waiting for them, and goes on to stream weights; the consumers meet it
// here once their input tile is in shared memory.
__device__ __forceinline__ void producer_start(const Ring& ring) {
  if (threadIdx.x % kWarp == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      mbar_init(ring.full + s, 2);
      mbar_init(ring.empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  asm volatile("bar.arrive 2, %0;" ::"n"(kBlockThreads) : "memory");
}

__device__ __forceinline__ void consumers_start() {
  asm volatile("bar.sync 2, %0;" ::"n"(kBlockThreads) : "memory");
}

// `count` consecutive floats from device memory into a stage, by the
// producer warp. Where both ends are 16-byte aligned the whole 16-byte
// units go as one bulk copy issued by lane 0 (kBulk) and only the last
// count % 4 floats by plain stores (!kBulk); else the whole span goes by
// plain stores. Returns the bytes the bulk copy counts on `bar`.
template <bool kBulk>
__device__ __forceinline__ uint32_t copy_span(float* dst, const float* __restrict__ src, int count,
                                              uint64_t* bar, int lane) {
  if (count <= 0) return 0;
  const int bulk = aligned16(src) && aligned16(dst) ? count & ~3 : 0;
  if constexpr (kBulk) {
    if (bulk > 0 && lane == 0) bulk_copy(dst, src, bulk * 4u, bar);
  } else {
    for (int i = bulk + lane; i < count; i += kWarp) dst[i] = __ldg(src + i);
  }
  return bulk * 4u;
}

// Weight rows [k0, k0 + n) of a row-major (K, N) matrix into a stage: one
// span. With kLs the first layer's rows below `split` come from W and the
// others from Wtail: two spans.
template <bool kLs, bool kBulk>
__device__ __forceinline__ uint32_t copy_chunk_rows(float* dst, const float* __restrict__ W,
                                                    const float* __restrict__ Wtail, int split,
                                                    int k0, int n, int N, uint64_t* bar,
                                                    int lane) {
  if constexpr (kLs) {
    const int head = max(0, min(n, split - k0));
    return copy_span<kBulk>(dst, W + (size_t)k0 * N, head * N, bar, lane) +
           copy_span<kBulk>(dst + (size_t)head * N, Wtail + (size_t)(k0 + head - split) * N,
                            (n - head) * N, bar, lane);
  } else {
    return copy_span<kBulk>(dst, W + (size_t)k0 * N, n * N, bar, lane);
  }
}

// Where the producer warp stands in the ring.
struct ProducerPos {
  int s = 0;
  uint32_t phase = 0;
  bool first = true;  // no chunk of this block has been issued yet
};

// A stage's copies are on their way and its plain stores done: close it,
// and go on to the next stage. The block's first chunk lands alone: with
// the ring's other stages in flight beside it, it would share the SM's
// copy rate with them, and the consumers would start that much later.
__device__ __forceinline__ void producer_advance(const Ring& ring, ProducerPos& pp, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.full + pp.s);
  if (pp.first) {
    mbar_wait(ring.full + pp.s, 0);
    pp.first = false;
  }
  if (++pp.s == ring.stages) {
    pp.s = 0;
    pp.phase ^= 1;
  }
}

// One row-major (K, N) matrix into the ring, `step` weight rows a chunk,
// in the order layer_tiles reads them.
template <bool kLs>
__device__ __forceinline__ void produce_rows(const Ring& ring, ProducerPos& pp,
                                             const float* __restrict__ W,
                                             const float* __restrict__ Wtail, int split, int K,
                                             int N, int step) {
  const int lane = threadIdx.x % kWarp;
  for (int k0 = 0; k0 < K; k0 += step) {
    const int n = min(step, K - k0);
    float* dst = ring.buf + (size_t)pp.s * ring.stage_floats;
    uint64_t* full = ring.full + pp.s;
    mbar_wait(ring.empty + pp.s, pp.phase ^ 1);  // passes at once on the first round
    // the bulk copies first, so that they fly while the plain stores run
    const uint32_t bytes = copy_chunk_rows<kLs, true>(dst, W, Wtail, split, k0, n, N, full, lane);
    if (lane == 0) mbar_arrive_expect_tx(full, bytes);
    copy_chunk_rows<kLs, false>(dst, W, Wtail, split, k0, n, N, full, lane);
    // zero rows up to the k-step: the activations' pad columns are
    // zeros too, and 0 x (whatever the stage held) could be a NaN
    for (int e = n * N + lane; e < ((n + 7) & ~7) * N; e += kWarp) dst[e] = 0.f;
    producer_advance(ring, pp, lane);
  }
}

// The producer warp of a forward kernel: every layer's weights, chunk by
// chunk, into the ring, in the order mlp_consume reads them.
template <bool kLs>
__device__ __forceinline__ void mlp_produce(const Ring& ring, const MlpArgs& args,
                                            const TilePlan& plan) {
  ProducerPos pp;
  for (int l = 0; l < args.n_layers; ++l) {
    const int K = args.dims[l];
    produce_rows<kLs>(ring, pp, args.w[l], kLs && l == 0 ? args.w0_tail : nullptr,
                      kLs && l == 0 ? args.split : K, K, args.dims[l + 1], plan.step[l]);
  }
}

// v rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero (cvt.rna.tf32.f32's result, on the integer pipe).
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(v) and lo = tf32(v - hi).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(v);
  lo = round_tf32(v - __uint_as_float(hi));
}

// v rounded to bfloat16, to nearest with ties to even, in the high half
// of an f32 (TF32) register: exact in TF32.
__device__ __forceinline__ uint32_t round_bf16(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v))) << 16;
}

// v into a hi and a lo plane at `at` (an act_index).
__device__ __forceinline__ void store_split(float* hi_plane, float* lo_plane, int at, float v) {
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  hi_plane[at] = __uint_as_float(hi);
  lo_plane[at] = __uint_as_float(lo);
}

__device__ __forceinline__ void store_split(const Tile& tile, int at, float v) {
  store_split(tile.hi, tile.lo, at, v);
}

// An input activation into the tile: split into the two planes, or with
// kBf16 rounded to bfloat16 into the hi plane alone.
template <bool kBf16>
__device__ __forceinline__ void store_act(const Tile& tile, int at, float v) {
  if constexpr (kBf16) {
    tile.hi[at] = __uint_as_float(round_bf16(v));
  } else {
    store_split(tile, at, v);
  }
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A bf16x2 word of two f32 values that are bfloat16 already (their high
// halves): lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// A bf16x2 word of two f32 values rounded to bfloat16, to nearest with ties
// to even (one cvt.rn.bf16x2.f32): lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of one k-step for a warp that owns T 8-column tiles, which
// lie side by side from column `base` on: column n of tile j is the
// layer's column base + n * T + j, so that a lane's T values of one
// weight row are neighbours and come with one load where the row length
// keeps them aligned (kVec: N % 4 == 0). w points at row t, column
// base + g * T of the k-step, and row t + 4 lies `half` floats on (4 N for
// rows of length N).
template <int T, bool kVec>
__device__ __forceinline__ void load_b(float (&b)[T][2], const float* __restrict__ w, int half) {
  if constexpr (kVec && T == 4) {
    const float4 r0 = *reinterpret_cast<const float4*>(w);
    const float4 r1 = *reinterpret_cast<const float4*>(w + half);
    b[0][0] = r0.x, b[1][0] = r0.y, b[2][0] = r0.z, b[3][0] = r0.w;
    b[0][1] = r1.x, b[1][1] = r1.y, b[2][1] = r1.z, b[3][1] = r1.w;
  } else if constexpr (kVec && T == 2) {
    const float2 r0 = *reinterpret_cast<const float2*>(w);
    const float2 r1 = *reinterpret_cast<const float2*>(w + half);
    b[0][0] = r0.x, b[1][0] = r0.y;
    b[0][1] = r1.x, b[1][1] = r1.y;
  } else {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      b[j][0] = w[j];
      b[j][1] = w[half + j];
    }
  }
}

// The bf16 mode's product of two k-steps of 8 (kFull; else of one, the
// second half zeros), in chunk_products' layout: a lane's A values are
// columns t, t + 4 of each step, its B rows t, t + 4 of each step, and
// column t of the first step pairs with column t of the second (the
// header's permutation of k).
template <int MT, int T, bool kVec, bool kFull>
__device__ __forceinline__ void bf16_products(float (&acc)[MT][T][4],
                                              const float* __restrict__ a_hi, int sa,
                                              const float* __restrict__ w, int half, int step8) {
  uint32_t ah[MT][4], bh[T][2];
  float b0[T][2], b1[T][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float2 h0 = *reinterpret_cast<const float2*>(a_hi + i * 16 * sa);
    const float2 h1 = *reinterpret_cast<const float2*>(a_hi + i * 16 * sa + 8);
    float2 h2 = make_float2(0.f, 0.f), h3 = h2;
    if constexpr (kFull) {
      h2 = *reinterpret_cast<const float2*>(a_hi + i * 16 * sa + 16);
      h3 = *reinterpret_cast<const float2*>(a_hi + i * 16 * sa + 24);
    }
    ah[i][0] = pack_bf16_exact(h0.x, h2.x), ah[i][1] = pack_bf16_exact(h0.y, h2.y);
    ah[i][2] = pack_bf16_exact(h1.x, h3.x), ah[i][3] = pack_bf16_exact(h1.y, h3.y);
  }
  load_b<T, kVec>(b0, w, half);
  if constexpr (kFull) load_b<T, kVec>(b1, w + step8, half);
#pragma unroll
  for (int j = 0; j < T; ++j) {
    bh[j][0] = pack_bf16(b0[j][0], kFull ? b1[j][0] : 0.f);
    bh[j][1] = pack_bf16(b0[j][1], kFull ? b1[j][1] : 0.f);
  }
#pragma unroll
  for (int j = 0; j < T; ++j) {
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], ah[i], bh[j]);
  }
}

// One chunk's products for a warp that owns T 8-column tiles: acc[i][j] +=
// a (MT 16-row blocks; the fragment's first pair at a_hi / a_lo, 2 * sa
// floats per row pair) times B (load_b's layout: `rows` weight rows, the
// lane's row t + 4 `half` floats after row t, each k-step's rows `step8`
// after the last's; 4 N and 8 N for rows of length N, chunk_products).
// T is a template argument so that the loop has no branch:
// the loads of a k-step then issue together and ahead of the products that
// need them, where a test per tile would make each tile wait for its own
// loads in turn. With kBf16 the a_hi plane holds bfloat16 values, B is
// rounded to bfloat16 and each pair of k-steps is one bf16 product
// (bf16_products).
template <int MT, int T, bool kVec, bool kBf16>
__device__ __forceinline__ void chunk_products_at(float (&acc)[MT][T][4],
                                                  const float* __restrict__ a_hi,
                                                  const float* __restrict__ a_lo, int sa,
                                                  const float* __restrict__ w, int half,
                                                  int step8, int rows) {
  if constexpr (kBf16) {
    // the 16-row tile's loop unrolled twice, the 64-row tile's not: each
    // the faster on the card (PERF.md, section 6)
    int k = 0;
    if constexpr (MT == 1) {
#pragma unroll 2
      for (; k + 16 <= rows; k += 16) {
        bf16_products<MT, T, kVec, true>(acc, a_hi, sa, w, half, step8);
        a_hi += 32;
        w += 2 * step8;
      }
    } else {
#pragma unroll 1
      for (; k + 16 <= rows; k += 16) {
        bf16_products<MT, T, kVec, true>(acc, a_hi, sa, w, half, step8);
        a_hi += 32;
        w += 2 * step8;
      }
    }
    if (k < rows) bf16_products<MT, T, kVec, false>(acc, a_hi, sa, w, half, step8);
    return;
  }
#pragma unroll 2
  for (int k = 0; k < rows; k += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[T][2], bl[T][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      // rows g and g + 8 of column k + t, then of column k + t + 4
      const float2 h0 = *reinterpret_cast<const float2*>(a_hi + i * 16 * sa);
      const float2 h1 = *reinterpret_cast<const float2*>(a_hi + i * 16 * sa + 8);
      const float2 l0 = *reinterpret_cast<const float2*>(a_lo + i * 16 * sa);
      const float2 l1 = *reinterpret_cast<const float2*>(a_lo + i * 16 * sa + 8);
      ah[i][0] = __float_as_uint(h0.x), ah[i][1] = __float_as_uint(h0.y);
      ah[i][2] = __float_as_uint(h1.x), ah[i][3] = __float_as_uint(h1.y);
      al[i][0] = __float_as_uint(l0.x), al[i][1] = __float_as_uint(l0.y);
      al[i][2] = __float_as_uint(l1.x), al[i][3] = __float_as_uint(l1.y);
    }
    float b[T][2];
    load_b<T, kVec>(b, w, half);
    a_hi += 16;
    a_lo += 16;
    w += step8;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      split_tf32(b[j][0], bh[j][0], bl[j][0]);
      split_tf32(b[j][1], bh[j][1], bl[j][1]);
    }
    // small terms first; consecutive products go to different
    // accumulators, so none waits for the one before it
#pragma unroll
    for (int j = 0; j < T; ++j) {
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], al[i], bh[j]);
    }
#pragma unroll
    for (int j = 0; j < T; ++j) {
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bl[j]);
    }
#pragma unroll
    for (int j = 0; j < T; ++j) {
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }
}

// chunk_products_at for weight rows of length N.
template <int MT, int T, bool kVec, bool kBf16>
__device__ __forceinline__ void chunk_products(float (&acc)[MT][T][4],
                                               const float* __restrict__ a_hi,
                                               const float* __restrict__ a_lo, int sa,
                                               const float* __restrict__ w, int N, int rows) {
  chunk_products_at<MT, T, kVec, kBf16>(acc, a_hi, a_lo, sa, w, 4 * N, 8 * N, rows);
}

// Where a consumer warp stands in the ring.
struct RingPos {
  int s = 0;
  uint32_t phase = 0;
};

// What mlp_consume hands a layer: the output and the residual; and, for a
// caller that keeps every layer's input (kOut: the backward kernel's
// recompute, on its wide path two pairs of planes), the planes a hidden
// layer's output goes to and their row stride, where the forward kernels
// overwrite the input planes.
struct TileIo {
  int sa;
  float* __restrict__ y;
  int row0, rows;
  const float* __restrict__ resid;
  int resid_stride;
  float* o_hi;
  float* o_lo;
  int so;
};

// One layer, or one pass of a wide layer's columns, for a warp that owns
// T 8-column tiles from column `base` on (T == 0: the warp only keeps the
// ring's pace): the chunks' products as they land, then the epilogue. The
// pass covers the N columns from c0 on of a layer ld columns wide, and a
// ring stage holds its weight rows S floats apart (a whole layer: c0 = 0,
// S = N = ld). Accumulator j holds rows r, r + 8 and the columns base +
// (2 t + e) * T + j of the pass, e = 0, 1: over j a lane's columns are the
// 2 T from base + 2 t T on. The bias is fetched first and added last, so
// its latency hides behind the products. A hidden layer's output
// overwrites the tile once every warp has read its inputs (with kOut it
// goes to io's planes instead), and is whole before any warp reads it;
// with kBf16 it is rounded to bfloat16 into the hi plane alone.
//
// kOut == kOutSegments (the backward's wide recompute; the forward kernels'
// wide path has its own loop, wide_tiles) also takes the contraction over
// K in segments:
// where a chunk ends past a multiple of kSegmentRows rows of K, the
// accumulators so far are added to the segments before them and start
// again from zero, and the segments are added in order before the bias.
// Over 8192 rows of K one tensor-core accumulator takes 1024 k-steps of
// three products and, on 23->8192^4->17, rounds further from the f32 plain
// version than 1e-4 of its scale, where the plain version lies well within
// it of float64 (scripts/diag_torch_wide_accuracy.py); a layer of at most
// kSegmentRows rows has one segment, and the same arithmetic as without.
template <int MT, int WM, int T, bool kVec, bool kLs, int kOut, bool kBf16>
__device__ __forceinline__ void layer_tiles(const Tile& tile, RingPos& pos, const TileIo& io,
                                            int K, int N, int S, int c0, int ld, int step,
                                            int base, const float* __restrict__ bias,
                                            bool last) {
  constexpr int TT = T > 0 ? T : 1;
  const Ring& ring = tile.ring;
  const int lane = threadIdx.x % kWarp;
  const int wm = threadIdx.x / kWarp % WM;
  const int g = lane / 4, t = lane % 4;  // the fragment's row (column of B) and k pair
  const int col = base + 2 * t * T;      // the lane's first output column
  float acc[MT][TT][4], b[TT][2];
#pragma unroll
  for (int j = 0; j < TT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col + e * T + j;
      b[j][e] = T > 0 && c < N ? __ldg(bias + c0 + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  const int a_at = act_index(wm * MT * 16 + g, t, io.sa);
  constexpr bool kSeg = kOut == kOutSegments && T > 0;
  float done[kSeg ? MT : 1][kSeg ? TT : 1][4];  // the segments before this one
  bool folded = false;
  for (int k0 = 0; k0 < K; k0 += step) {
    const int n = min(step, K - k0);
    mbar_wait(ring.full + pos.s, pos.phase);
    if constexpr (T > 0) {
      const float* w = ring.buf + (size_t)pos.s * ring.stage_floats + t * S + base + g * T;
      chunk_products<MT, T, kVec, kBf16>(acc, tile.hi + a_at + 2 * k0, tile.lo + a_at + 2 * k0,
                                         io.sa, w, S, (n + 7) & ~7);
    }
    if constexpr (kSeg) {
      if (k0 + step < K && (k0 + step) / kSegmentRows != k0 / kSegmentRows) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < TT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              done[i][j][e] = folded ? done[i][j][e] + acc[i][j][e] : acc[i][j][e];
              acc[i][j][e] = 0.f;
            }
          }
        }
        folded = true;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty + pos.s);
    if (++pos.s == ring.stages) {
      pos.s = 0;
      pos.phase ^= 1;
    }
  }
  if constexpr (kSeg) {
    if (folded) {  // the segments before, then the last
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < TT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = done[i][j][e] + acc[i][j][e];
        }
      }
    }
  }

  if (last) {
    if constexpr (T > 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm * MT + i) * 16 + g + 8 * h;
          if (io.row0 + r >= io.rows) continue;
          float* yr = io.y + (size_t)(io.row0 + r) * ld + c0;
#pragma unroll
          for (int j = 0; j < T; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = col + e * T + j;
              if (c >= N) continue;
              float v = acc[i][j][2 * h + e] + b[j][e];
              if constexpr (kLs) v += io.resid[r * io.resid_stride + c0 + c];
              yr[c] = v;
            }
          }
        }
      }
    }
    return;
  }
  consumer_sync();
  if constexpr (T > 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      // the lane's 2 T columns x rows (g, g + 8) are 4 T neighbouring
      // floats of each plane: position p is column p / 2, row g + 8 (p % 2)
      float hi[4 * T], lo[4 * T];
#pragma unroll
      for (int p = 0; p < 4 * T; ++p) {
        const int co = p / 2, e = co / T, j = co % T;
        // columns past N pad the next layer's K: zeros
        const float v = col + co < N ? fmaxf(acc[i][j][2 * (p % 2) + e] + b[j][e], 0.f) : 0.f;
        uint32_t vh, vl;
        if constexpr (kBf16) {
          vh = round_bf16(v), vl = 0u;
        } else {
          split_tf32(v, vh, vl);
        }
        hi[p] = __uint_as_float(vh);
        lo[p] = __uint_as_float(vl);
      }
      const int at = act_index((wm * MT + i) * 16 + g, c0 + col, kOut ? io.so : io.sa);
      float* o_hi = kOut ? io.o_hi : tile.hi;
      float* o_lo = kOut ? io.o_lo : tile.lo;
#pragma unroll
      for (int p = 0; p < 4 * T; p += 4) {
        *reinterpret_cast<float4*>(o_hi + at + p) =
            make_float4(hi[p], hi[p + 1], hi[p + 2], hi[p + 3]);
        if constexpr (!kBf16) {
          *reinterpret_cast<float4*>(o_lo + at + p) =
              make_float4(lo[p], lo[p + 1], lo[p + 2], lo[p + 3]);
        }
      }
    }
  }
  consumer_sync();
}

// One layer (K, N) for the consumer warps, WM row groups x WN =
// kConsumerWarps / WM column groups. The layer's 8-column tiles are dealt
// to the column groups in runs of tb = ceil(tiles / WN), so a narrow layer
// (17 columns: 3 tiles) spreads over as many warps as it has tiles; a
// layer is at most WN * 8 * kWarpTiles wide. Expands where tile, pos, io,
// K, N and last are in scope; kBf16 selects the bf16 mode; STEP (weight
// rows per chunk) and BIAS are expressions, evaluated where a layer_tiles
// instance is called. (A macro
// and not a function: as a function that both callers shared,
// fused_mlp_fwd's 16-row instance compiled to 92 registers for 90 and its
// 512-row cost call took 6% longer.) MLP_CONSUME_COLS is the same for one
// pass of a wide layer: NP columns from C0 on of a layer LD wide, whose
// weight rows lie S floats apart in a stage.
#define MLP_CONSUME_LAYER(MT, WM, kLs, kOut, kBf16, STEP, BIAS) \
  MLP_CONSUME_COLS(MT, WM, kLs, kOut, kBf16, STEP, BIAS, N, N, 0, N)
#define MLP_CONSUME_COLS(MT, WM, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD)                      \
  do {                                                                                            \
    constexpr int WN = kConsumerWarps / (WM);                                                     \
    /* neighbouring warps, which share an SM sub-partition four warps apart, take */              \
    /* different column groups, so a layer's last, narrower groups spread over the */             \
    /* sub-partitions */                                                                          \
    const int wn = threadIdx.x / kWarp / (WM);                                                    \
    const int tiles = ((NP) + 7) / 8;                                                             \
    const int tb = (tiles + WN - 1) / WN;                                                         \
    const int base = wn * tb * 8;                                                                 \
    const int mine = max(0, min(tb, tiles - wn * tb));                                            \
    if ((S) % 4 == 0) {                                                                           \
      switch (mine) {                                                                             \
        case 0: MLP_LAYER(MT, WM, 0, true, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD); break;   \
        case 1: MLP_LAYER(MT, WM, 1, true, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD); break;   \
        case 2: MLP_LAYER(MT, WM, 2, true, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD); break;   \
        case 3: MLP_LAYER(MT, WM, 3, true, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD); break;   \
        default:                                                                                  \
          MLP_LAYER(MT, WM, kWarpTiles, true, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD);       \
          break;                                                                                  \
      }                                                                                           \
    } else {                                                                                      \
      switch (mine) {                                                                             \
        case 0: MLP_LAYER(MT, WM, 0, false, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD); break;  \
        case 1: MLP_LAYER(MT, WM, 1, false, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD); break;  \
        case 2: MLP_LAYER(MT, WM, 2, false, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD); break;  \
        case 3: MLP_LAYER(MT, WM, 3, false, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD); break;  \
        default:                                                                                  \
          MLP_LAYER(MT, WM, kWarpTiles, false, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD);      \
          break;                                                                                  \
      }                                                                                           \
    }                                                                                             \
  } while (0)
#define MLP_LAYER(MT, WM, T, V, kLs, kOut, kBf16, STEP, BIAS, NP, S, C0, LD)                     \
  layer_tiles<MT, WM, T, V, kLs, kOut, kBf16>(tile, pos, io, K, NP, S, C0, LD, STEP, base, BIAS, \
                                              last)

// The consumer warps of a forward kernel: the whole stack over one row
// tile of 16 * MT * WM rows whose input rows are split into tile.hi and
// tile.lo (act_index's layout, columns up to the next multiple of 8
// zeroed); both planes are overwritten by every hidden layer. The output
// rows go to y (rows past `rows` are not stored), with kLs plus resid[r *
// resid_stride + c]. With kBf16 the input rows are in tile.hi alone,
// rounded to bfloat16 (store_act), and every product is bfloat16's. Called
// by all kConsumers consumer threads.
template <int MT, int WM, bool kLs, bool kBf16>
__device__ __forceinline__ void mlp_consume(const Tile& tile, const MlpArgs& args,
                                            const TilePlan& plan, float* __restrict__ y,
                                            int row0, int rows, const float* __restrict__ resid,
                                            int resid_stride) {
  const TileIo io{plan.sa, y, row0, rows, resid, resid_stride, nullptr, nullptr, 0};
  RingPos pos;
  for (int l = 0; l < args.n_layers; ++l) {
    const int K = args.dims[l], N = args.dims[l + 1];
    const bool last = l == args.n_layers - 1;
    MLP_CONSUME_LAYER(MT, WM, kLs, false, kBf16, plan.step[l], args.b[l]);
  }
}

// ---------------------------------------------------------------------------
// Column slabs: the backward's wide walk (fused_mlp_bwd.cu) streams a layer
// wider than one pass of the warps' columns through the ring pass by pass.

// The generic pointer p, of which the compiler knows nothing more.
__device__ __forceinline__ float* opaque(float* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// Weight rows [k0, k0 + n) x columns [c0, c0 + cols) of a row-major (K, N)
// matrix into a stage, a row every `stride` floats: one span a row; with
// kLs the first layer's rows from `split` on come from Wtail. Returns the
// bytes the bulk copies count on `bar` (copy_span).
template <bool kLs, bool kBulk>
__device__ __forceinline__ uint32_t copy_chunk_slab(float* dst, const float* __restrict__ W,
                                                    const float* __restrict__ Wtail, int split,
                                                    int k0, int n, int N, int c0, int cols,
                                                    int stride, uint64_t* bar, int lane) {
  uint32_t bytes = 0;
  for (int r = 0; r < n; ++r) {
    const int k = k0 + r;
    const float* src = (kLs && k >= split ? Wtail + (size_t)(k - split) * N : W + (size_t)k * N);
    bytes += copy_span<kBulk>(dst + (size_t)r * stride, src + c0, cols, bar, lane);
  }
  return bytes;
}

// One layer into the ring in the order the backward's recompute reads it: a
// layer of at most pass_cols columns as produce_rows streams it, a wider one
// pass by pass, each chunk a column slab pass_cols floats a row (the last
// pass's narrower slab too; its rows' tails are never read into an output).
template <bool kLs>
__device__ __forceinline__ void produce_layer_wide(const Ring& ring, ProducerPos& pp,
                                                   const LayerDesc& d,
                                                   const float* __restrict__ Wtail, int split,
                                                   int pass_cols) {
  if (d.N <= pass_cols) {
    produce_rows<kLs>(ring, pp, d.w, Wtail, split, d.K, d.N, d.step);
    return;
  }
  const int lane = threadIdx.x % kWarp;
  for (int c0 = 0; c0 < d.N; c0 += pass_cols) {
    const int cols = min(pass_cols, d.N - c0);
    for (int k0 = 0; k0 < d.K; k0 += d.step) {
      const int n = min(d.step, d.K - k0);
      float* dst = ring.buf + (size_t)pp.s * ring.stage_floats;
      uint64_t* full = ring.full + pp.s;
      mbar_wait(ring.empty + pp.s, pp.phase ^ 1);  // passes at once on the first round
      const uint32_t bytes = copy_chunk_slab<kLs, true>(dst, d.w, Wtail, split, k0, n, d.N, c0,
                                                        cols, pass_cols, full, lane);
      if (lane == 0) mbar_arrive_expect_tx(full, bytes);
      copy_chunk_slab<kLs, false>(dst, d.w, Wtail, split, k0, n, d.N, c0, cols, pass_cols, full,
                                  lane);
      // zero rows up to the k-step, as produce_rows does
      for (int e = n * pass_cols + lane; e < ((n + 7) & ~7) * pass_cols; e += kWarp) dst[e] = 0.f;
      producer_advance(ring, pp, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide path of the forward kernels (fused_mlp_fwd.cu, fused_ls_step.cu):
// stacks of any depth and width, a cluster of blocks to a row tile.
//
// A stack deeper than kInlineLayers, or one the path above does not take (a
// layer wider than one pass of the warps' columns, or planes that do not fit
// beside the ring in a block's shared memory), runs through the same
// products, fragments and epilogue arithmetic, laid out otherwise:
//  * A cluster of C blocks (1, 2, 4, 8, or 16 with the non-portable size)
//    owns a row tile. Every layer's output columns are dealt to the C
//    blocks in runs of whole 8-column tiles (WideLayer.cols a block: block
//    r owns [r cols, (r + 1) cols), a last block may own fewer or none), and
//    each block computes its columns over all K, in passes of at most
//    P = 32 * WN columns (512 on the 16-row tile, 256 on the 64-row tile).
//    Each weight element of a row tile is read by one block of the cluster.
//  * A hidden layer's output stays in the shared memory of the block that
//    computed it: its columns as f32 rows, relu'd (sb floats a row), in one
//    of two buffers that alternate layer by layer. No activation of the
//    forward or the step touches device memory up to the widths a cluster
//    of 16 holds (streamed plans, below, past them): a layer of 8192
//    columns on a cluster of 8 is 1024 columns a block.
//  * The ring carries both operands. A stage holds a chunk of `step` rows
//    of K: the weight rows [k0, k0 + step) of the block's pass, then the
//    layer input's columns [k0, k0 + step) of the tile's rows, split into a
//    hi and a lo plane (act_index's layout at row stride step + 4). Four
//    producer warps, one an SM sub-partition, fill four stages at once (a
//    chunk a warp, in turn): each reads the input columns from the block
//    that owns them, through distributed shared memory (ld.shared::cluster
//    at mapa'd addresses; the first layer's rows from x in device memory,
//    the step's [x, u] from x3 and u there), and splits them
//    (with kBf16 rounds them to bfloat16) as it stores them: the same parts
//    the path above splits in its epilogue, so the products see the same
//    bits. Consumers then load every fragment from local shared memory; a
//    fragment read across the cluster would cost an SM-to-SM trip for each
//    of the 16 warps that share the tile's rows.
//  * Weights come without the producer copying floats (wide_mode): a layer
//    that one pass covers (N <= P: the 17-wide last layers, 200, 64) as
//    whole rows, the chunk one contiguous bulk copy, whatever N's
//    alignment (its rows lie N floats apart in the stage, as on the path
//    above); a wider layer with N % 4 == 0 by TMA, a 2-D tensor map a
//    layer and one box of 32 columns x step rows a lane, swizzled by 128
//    bytes so that fragment loads meet no bank conflict (rows past K and
//    columns past N arrive as zeros); a wider layer with N % 4 != 0 (777)
//    or unaligned weights, whose rows TMA cannot address, a bulk copy a
//    row, each row placed at its 16-byte phase so that only its up to 3
//    ragged floats go by 4-byte cp.async (the step's first layer, whose rows
//    come from two tensors, by 4-byte cp.async from every lane where one
//    pass does not cover it). Per-row copies cost a warp about a hundred
//    clocks each
//    (clock readings: PERF.md section 6), per-lane cp.async of a
//    whole slab more, which is why the two wide kinds differ. A stage is
//    full after the bulk and TMA bytes, each lane's small copies
//    (cp.async.mbarrier.arrive.noinc) and the producer's stores
//    (kWideFullArrivals).
//  * Layers meet at the cluster barrier (barrier.cluster.arrive / wait, all
//    threads of the cluster; a named barrier of the block on a cluster of
//    one): the consumers arrive once they have written a hidden layer's
//    columns (the step's block 0 also once it has written u), and wait only
//    before their next arrival; the producers arrive and wait before they
//    stage a layer that reads them. Two buffers suffice: a block writes a
//    buffer again only after every producer has passed the barrier of the
//    layer after the one that read it last. A last round keeps every
//    block's shared memory alive until no peer reads it.
//  * Segments. The contraction over a layer's K rows is summed in segments
//    of kSegmentRows rows, added in order: steps are powers of two of at
//    most kSegmentRows, so the segments end at multiples of it.
//  * A cluster walks row tiles, clusters apart; its blocks' rings run
//    across tiles. The launcher picks C: the smallest size whose slices and
//    ring fit, raised to fill the SMs with one wave of clusters (up to 8)
//    while some layer deals a block more 8-column tiles than it has column
//    groups, and halved while cudaOccupancyMaxActiveClusters says the card
//    cannot place it.
//  * A layer too wide for any cluster's shared memory (its slices' two
//    buffers beside the ring on 16 blocks: past about 18,000 columns)
//    streams instead: the plan is `streamed`, each cluster's two buffers
//    (whole rows of the widest hidden layer) lie in a device workspace the
//    caller provides, the consumers store their columns there and the
//    producers stage them back from L2 (ld.global.cg: a peer on another SM
//    wrote them) after the same barriers. Every other stack keeps its
//    activations on chip and takes no workspace.
//  * The table (WideTable: each layer's WideLayer and, for kRowsBoxes
//    layers, its tensor map) travels in the launch's parameters
//    (__grid_constant__) for the first kTableLayers layers; the launch
//    copies nothing and can be captured in a CUDA graph. A deeper stack's
//    further layers lie at the workspace's head, copied in at each launch
//    from pageable memory (the stream syncs first, and capture refuses it).

constexpr int kPortableCluster = 8;  // the cluster size every Hopper part places
constexpr int kMaxCluster = 16;      // ... and the most, with the non-portable attribute
// a wide stage is full after the bulk bytes' arrival, each lane's small copies, the stores
constexpr int kWideFullArrivals = kWarp + 2;
constexpr int kWideProducers = 4;  // producer warps of a wide-path block, one an SM sub-partition
static_assert(kWideProducers <= kMaxStages, "the wide ring has a stage a producer warp");
constexpr int kWideThreads = kConsumers + kWideProducers * kWarp;
constexpr int kNoPlan = -3;  // a wide launcher's answer where no cluster size fits and is placed
constexpr int kNeedWorkspace = -2;  // ... where it needs a workspace (the bytes in *needed)
constexpr int kTableLayers = 64;    // layers whose table travels in the launch's parameters

// One layer of a wide-path stack as the forward kernels read it: 32 bytes.
struct WideLayer {
  const float* w;  // (K, N) row-major
  const float* b;  // (N)
  int K, N;
  int step;  // rows of K a chunk of the ring: a power of two, at most kSegmentRows
  int cols;  // the output columns a block of the cluster owns: whole tiles of 8
};

// A stack as a wide kernel's __grid_constant__ parameter (about 10 KB):
// layer l < kTableLayers's entry and tensor map here, a deeper layer's at
// far_layer / far_map [l - kTableLayers] (the workspace's head).
struct WideTable {
  CUtensorMap map[kTableLayers];  // layer l's weights (kRowsBoxes layers; zeros else)
  WideLayer layer[kTableLayers];
  const WideLayer* far_layer;
  const CUtensorMap* far_map;
  float* acts;  // a streamed plan's buffers: cluster i's two at acts + 2 i tile_rows sb
  const float* w0_tail;  // as in MlpArgs
  int split;
  int n_layers;
};

struct WidePlan {
  int cluster;       // C
  int pass_cols;     // P
  int sb;            // the activation buffers' row stride, floats; 0: no hidden layer
  int stage_floats;  // floats per ring stage
  int stages;
  int streamed;      // 1: the buffers lie in device memory (whole rows), else a block's slices
  size_t smem;       // bytes
};

__device__ __forceinline__ const WideLayer& wide_layer(const WideTable& t, int l) {
  return l < kTableLayers ? t.layer[l] : t.far_layer[l - kTableLayers];
}

__device__ __forceinline__ const CUtensorMap* wide_map(const WideTable& t, int l) {
  return l < kTableLayers ? t.map + l : t.far_map + (l - kTableLayers);
}

// How a layer's weight rows reach a stage (the header's weights).
constexpr int kRowsWhole = 0, kRowsBoxes = 1, kRowsEach = 2;
constexpr int kBoxCols = 32;       // a TMA box's columns: 128 bytes, the swizzle's span
constexpr int kMaxBoxRows = 256;   // ... and the most rows a box takes

// The mode of layer d at P columns a pass; split_first: the step's first
// layer, whose rows come from two tensors. TMA takes 16-byte aligned
// weights only: a view that is not goes row by row.
__host__ __device__ __forceinline__ int wide_mode(const WideLayer& d, int pass_cols,
                                                  bool split_first) {
  if (d.N <= pass_cols) return kRowsWhole;
  const bool aligned = (reinterpret_cast<uintptr_t>(d.w) & 15) == 0;
  return d.N % 4 == 0 && aligned && !split_first ? kRowsBoxes : kRowsEach;
}

// Floats a weight row takes in a stage for a pass pw wide: whole rows of N;
// boxes of 32 columns; or rows each at their phase (up to 3 floats in),
// 8 (mod 32) floats apart for conflict-free fragment loads.
__host__ __device__ __forceinline__ int wide_row_floats(int mode, int pw, int N) {
  if (mode == kRowsWhole) return N;
  if (mode == kRowsBoxes) return (pw + kBoxCols - 1) / kBoxCols * kBoxCols;
  return ((pw + 3 + 23) & ~31) + 8;
}

// Lay out a stack (layers[l].K, .N) for a cluster of `cluster` blocks on
// tile_rows rows, and set each layer's cols and step. Shared memory: the two
// buffers of the widest hidden layer's slice (none where `streamed`: the
// buffers, whole rows of the widest hidden layer, lie in device memory),
// and a ring of kWideProducers stages (one a producer warp: a warp's first
// chunk of a layer then never waits for a stage of that layer, which the
// layer's barrier holds back), each the deepest of 64, 32, 16 or 8 weight
// rows of the widest pass with their input planes that fits. False where
// none does (never where `streamed`).
inline bool plan_wide(WideLayer* layers, int n_layers, int tile_rows, int pass_cols, int cluster,
                      bool split_first, bool streamed, WidePlan* p) {
  int slice = 0, hidden = 0, widest = 8;
  for (int l = 0; l < n_layers; ++l) {
    const int tiles = (layers[l].N + 7) / 8;
    layers[l].cols = 8 * ((tiles + cluster - 1) / cluster);
    if (l < n_layers - 1) {
      slice = max(slice, layers[l].cols);
      hidden = max(hidden, layers[l].N);
    }
    const int mode = wide_mode(layers[l], pass_cols, split_first && l == 0);
    widest = max(widest, wide_row_floats(mode, min(layers[l].cols, pass_cols), layers[l].N));
  }
  p->cluster = cluster;
  p->pass_cols = pass_cols;
  p->streamed = streamed ? 1 : 0;
  p->sb = streamed ? (hidden + 3) & ~3 : slice > 0 ? slice + 4 : 0;
  // the ring starts at a multiple of 1024 bytes (TMA's swizzled boxes): up
  // to 1024 bytes lie before it
  const size_t fixed =
      kBarrierBytes + 1024 + (2ull * tile_rows * (streamed ? 0 : p->sb) + 8) * sizeof(float);
  for (int rows = 64; rows >= 8; rows /= 2) {
    p->stage_floats = (rows * widest + 2 * tile_rows * (rows + 4) + 255) & ~255;
    const size_t stage = p->stage_floats * sizeof(float);
    if (fixed + kWideProducers * stage > kMaxSmem) continue;
    p->stages = kWideProducers;
    p->smem = fixed + p->stages * stage;
    for (int l = 0; l < n_layers; ++l) {
      const int mode = wide_mode(layers[l], pass_cols, split_first && l == 0);
      const int wf = wide_row_floats(mode, min(layers[l].cols, pass_cols), layers[l].N);
      int s = mode == kRowsBoxes ? kMaxBoxRows : kSegmentRows;
      while (s * wf + 2 * tile_rows * (s + 4) > p->stage_floats) s /= 2;
      layers[l].step = s;
    }
    return true;
  }
  return false;
}

// Clusters of `cluster` blocks of `kernel` that the card holds at once at a
// block's whole shared memory (0: it cannot place one), read once per
// device and size into placed[device][log2 cluster] (0: not read yet).
template <typename Kernel>
cudaError_t clusters_placed(Kernel kernel, int device, int cluster, int (*placed)[5], int* n) {
  int slot = 0;
  while ((1 << slot) < cluster) ++slot;
  if (device < kMaxDevices && placed[device][slot] != 0) {
    *n = max(0, placed[device][slot]);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = kMaxSmem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  if (e != cudaSuccess) {  // a size the card refuses is one it cannot place
    cudaGetLastError();
    *n = 0;
  }
  if (device < kMaxDevices) placed[device][slot] = *n > 0 ? *n : -1;
  return cudaSuccess;
}

// Plan a wide-path launch of `kernel` at tile_rows rows over `tiles` row
// tiles (the module's header: the cluster size). Sets *clusters to the
// clusters to launch, or 0 where no size up to `most` fits and is placed;
// with may_stream a stack whose slices no such cluster holds streams.
template <typename Kernel>
cudaError_t plan_launch(Kernel kernel, int device, int (*placed)[5], std::vector<WideLayer>& layers,
                        int tile_rows, bool split_first, int tiles, int sms, int most,
                        bool may_stream, WidePlan* plan, int* clusters) {
  *clusters = 0;
  const int n_layers = (int)layers.size();
  const int pass_cols = 8 * kWarpTiles * kConsumerWarps / (tile_rows == 64 ? 2 : 1);
  bool streamed = false;
  int fit = 1;
  while (fit <= most && !plan_wide(layers.data(), n_layers, tile_rows, pass_cols, fit,
                                   split_first, false, plan)) {
    fit *= 2;
  }
  if (fit > most) {
    if (!may_stream) return cudaSuccess;
    streamed = true;
    fit = 1;
  }
  // more blocks a tile while a wave of clusters still fits the SMs, and
  // while some layer deals a block more 8-column tiles than it has column
  // groups (past that a block's warps hold one tile each: more blocks add
  // barriers, not speed)
  const int groups = kConsumerWarps / (tile_rows == 64 ? 2 : 1);
  int widest = 1;
  for (const WideLayer& d : layers) widest = max(widest, (d.N + 7) / 8);
  int want = 1;
  while (want < kPortableCluster && (size_t)tiles * want * 2 <= (size_t)sms &&
         (widest + want - 1) / want > groups) {
    want *= 2;
  }
  for (int c = max(fit, want); c >= fit; c /= 2) {
    int n = 0;
    const cudaError_t e = clusters_placed(kernel, device, c, placed, &n);
    if (e != cudaSuccess) return e;
    if (n > 0) {
      plan_wide(layers.data(), n_layers, tile_rows, pass_cols, c, split_first, streamed, plan);
      *clusters = min(tiles, n);
      return cudaSuccess;
    }
  }
  return cudaSuccess;
}

// Let `kernel` take a block's whole shared memory and clusters of 16, once
// per device.
template <typename Kernel>
cudaError_t allow_wide(Kernel kernel, int device, bool* done) {
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess && device < kMaxDevices) done[device] = true;
  return e;
}

// The last wide-path launch of the library: tile rows, blocks a cluster,
// clusters, shared memory a block (bytes), a streamed plan (1) or not.
int last_wide[5];

// Launch a wide-path kernel as `clusters` clusters of plan.cluster blocks
// (and note it in last_wide).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int tile_rows, const WidePlan& plan,
                            int clusters, cudaStream_t stream, Args... args) {
  last_wide[0] = tile_rows;
  last_wide[1] = plan.cluster;
  last_wide[2] = clusters;
  last_wide[3] = (int)plan.smem;
  last_wide[4] = plan.streamed;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = plan.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * plan.cluster);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda), once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The table of a stack for a wide launch of `clusters` clusters into *t,
// the kernels' parameter: the layers, and a tensor map a kRowsBoxes layer
// (its (K, N) weights in boxes of 32 columns x step rows, swizzled by 128
// bytes). A stack deeper than kTableLayers, or a streamed plan, needs a
// workspace: the further layers' entries, then their maps, then the
// clusters' buffers. Where `work` holds fewer bytes than that the answer is
// kNeedWorkspace, the bytes in *needed; else the further layers are copied
// to its head on `stream`. -1 where a map cannot be made.
inline int wide_table(const std::vector<WideLayer>& layers, const WidePlan& plan, int tile_rows,
                      int clusters, const float* w0_tail, int split, void* work,
                      size_t work_bytes, size_t* needed, cudaStream_t stream, WideTable* t) {
  const int n = (int)layers.size();
  const int far = max(0, n - kTableLayers);
  const size_t far_head = ((size_t)far * sizeof(WideLayer) + 127) & ~(size_t)127;
  const size_t far_bytes = (far_head + (size_t)far * sizeof(CUtensorMap) + 255) & ~(size_t)255;
  const size_t acts =
      plan.streamed ? (size_t)clusters * 2 * tile_rows * plan.sb * sizeof(float) : 0;
  *needed = far_bytes + acts;
  if (*needed > 0 && (work == nullptr || work_bytes < *needed)) return kNeedWorkspace;
  std::vector<unsigned char> host(far_bytes, 0);
  memset(t, 0, sizeof(WideTable));
  for (int l = 0; l < n; ++l) {
    const WideLayer& d = layers[l];
    CUtensorMap* map = t->map + l;
    if (l < kTableLayers) {
      t->layer[l] = d;
    } else {
      memcpy(host.data() + (l - kTableLayers) * sizeof(WideLayer), &d, sizeof(WideLayer));
      map = reinterpret_cast<CUtensorMap*>(host.data() + far_head) + (l - kTableLayers);
    }
    if (wide_mode(d, plan.pass_cols, w0_tail != nullptr && l == 0) != kRowsBoxes) continue;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return -1;
    const cuuint64_t dims[2] = {(cuuint64_t)d.N, (cuuint64_t)d.K};
    const cuuint64_t strides[1] = {(cuuint64_t)d.N * sizeof(float)};
    const cuuint32_t box[2] = {kBoxCols, (cuuint32_t)d.step};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(d.w), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return -1;
    }
  }
  unsigned char* base = static_cast<unsigned char*>(work);
  if (far > 0) {
    t->far_layer = reinterpret_cast<const WideLayer*>(base);
    t->far_map = reinterpret_cast<const CUtensorMap*>(base + far_head);
  }
  if (plan.streamed) t->acts = reinterpret_cast<float*>(base + far_bytes);
  t->w0_tail = w0_tail;
  t->split = split;
  t->n_layers = n;
  if (far > 0) {
    return (int)cudaMemcpyAsync(work, host.data(), far_bytes, cudaMemcpyHostToDevice, stream);
  }
  return 0;
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return (int)r;
}

// The cluster barrier, split: arrive (release) and wait (acquire), by every
// thread of the cluster in turn.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// p, in this block's shared memory, in block `rank` of the cluster: a
// shared::cluster address.
__device__ __forceinline__ uint32_t cluster_map(const float* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// A block's shared memory on the wide path: [mbarriers][buffer 0][buffer
// 1][ring + 8], the ring 1024-byte aligned; a streamed plan's buffers are
// its cluster's pair at `acts` (device memory).
struct WideTile {
  Ring ring;
  float* buf[2];  // tile_rows x sb each: hidden outputs, this block's columns (streamed: all)
};

__device__ __forceinline__ WideTile carve_wide(unsigned char* smem, const WidePlan& p,
                                               int tile_rows, float* acts) {
  WideTile t;
  t.ring.full = reinterpret_cast<uint64_t*>(smem);
  t.ring.empty = t.ring.full + kMaxStages;
  float* f = reinterpret_cast<float*>(smem + kBarrierBytes);
  float* pair = p.streamed ? acts + (size_t)cluster_index() * 2 * tile_rows * p.sb : f;
  t.buf[0] = pair;
  t.buf[1] = pair + (size_t)tile_rows * p.sb;
  // the ring from smem itself, so that the compiler knows its loads and
  // stores for shared ones (through `pair`, a generic pointer, it would not)
  float* ring = f + (p.streamed ? 0 : 2 * (size_t)tile_rows * p.sb);
  t.ring.buf = ring + ((1024u - (smem_addr(ring) & 1023u)) & 1023u) / 4;  // 1024-byte aligned
  t.ring.stage_floats = p.stage_floats;
  t.ring.stages = p.stages;
  return t;
}

// Where a layer's input comes from, for the producer warps' staging: rows
// of `ld` floats from p (x in device memory, `valid` of them, later rows
// zeros; the step's columns from `split` on from p2, rows of ld2: its u
// beside x3; with l2 a streamed buffer, read from L2), or with owner > 0 a
// hidden layer's output, `owner` columns in each block's buffer (p: this
// block's), column c in block c / owner. Columns from K on are zeros.
struct ActSource {
  const float* p;
  int ld;
  int valid;
  int K;
  int owner;
  const float* p2;
  int ld2;
  int split;
  bool l2 = false;
};

// Columns c .. c + 3 (c < K) of row r of a source whose row r starts at
// base + r * ld (a generic address; with l2 in device memory, read by
// ld.global.cg), or with `remote` at the shared::cluster address at + 4 r
// ld: one 16-byte load where `vec`.
__device__ __forceinline__ float4 load_act4(const float* base, uint32_t at, bool remote, bool l2,
                                            int ld, int r, int valid, int c, int K, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= valid) return v;
  if (remote) {
    const uint32_t q = at + 4u * r * ld;
    if (vec) return ld_cluster4(q);
    v.x = ld_cluster(q);
    if (c + 1 < K) v.y = ld_cluster(q + 4);
    if (c + 2 < K) v.z = ld_cluster(q + 8);
    if (c + 3 < K) v.w = ld_cluster(q + 12);
    return v;
  }
  const float* q = base + (size_t)r * ld;
  if (l2) {
    if (vec) return __ldcg(reinterpret_cast<const float4*>(q));
    v.x = __ldcg(q);
    if (c + 1 < K) v.y = __ldcg(q + 1);
    if (c + 2 < K) v.z = __ldcg(q + 2);
    if (c + 3 < K) v.w = __ldcg(q + 3);
    return v;
  }
  if (vec) return *reinterpret_cast<const float4*>(q);
  v.x = q[0];
  if (c + 1 < K) v.y = q[1];
  if (c + 2 < K) v.z = q[2];
  if (c + 3 < K) v.w = q[3];
  return v;
}

// Rows r and r + 8 of four columns (v[0], v[1]) into a stage's planes at
// `at` (act_index's layout: the two rows interleaved), split into TF32
// parts, with kBf16 rounded to bfloat16 into hi alone.
template <bool kBf16>
__device__ __forceinline__ void store_pair(float* hi, float* lo, int at, const float4 (&v)[2]) {
  const float in[8] = {v[0].x, v[1].x, v[0].y, v[1].y, v[0].z, v[1].z, v[0].w, v[1].w};
  float h[8], l[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    uint32_t vh, vl = 0u;
    if constexpr (kBf16) {
      vh = round_bf16(in[e]);
    } else {
      split_tf32(in[e], vh, vl);
    }
    h[e] = __uint_as_float(vh);
    l[e] = __uint_as_float(vl);
  }
  *reinterpret_cast<float4*>(hi + at) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(hi + at + 4) = make_float4(h[4], h[5], h[6], h[7]);
  if constexpr (!kBf16) {
    *reinterpret_cast<float4*>(lo + at) = make_float4(l[0], l[1], l[2], l[3]);
    *reinterpret_cast<float4*>(lo + at + 4) = make_float4(l[4], l[5], l[6], l[7]);
  }
}

// Columns [k0, k0 + n8) of a layer's input for the tile's rows into a
// stage's hi and lo planes (act_index's layout at row stride sa), split
// into TF32 parts, with kBf16 rounded to bfloat16 into hi alone. A lane
// keeps one group of four columns (its source found once: the owning
// block's buffer, or the rows) and takes every lpg-th pair of rows (r, r +
// 8) of it, kBatch pairs' loads in flight together. A hidden output (all
// rows there, K % 4 == 0: every group whole or past K) takes a path without
// tests; the first layer's rows the general one.
template <int TM, bool kBf16>
__device__ __forceinline__ void stage_acts(float* hi, int sa, const ActSource& s, int k0, int n8,
                                           int lane) {
  constexpr int kPairs = TM / 2, kBatch = 4;
  float* lo = hi + TM * sa;
  const int groups = n8 / 4;
  const int lpg = groups >= kWarp ? 1 : kWarp / groups;  // lanes a column group
  const bool plain = s.valid >= TM && s.K % 4 == 0 && (s.ld & 3) == 0 && s.p2 == nullptr;
  for (int gq = lane / lpg; gq < groups; gq += kWarp / lpg) {
    const int c = k0 + 4 * gq;
    const bool remote = s.owner > 0, inside = c < s.K;
    const float* base = s.p + (remote ? c % s.owner : c);
    const uint32_t at = remote && inside ? cluster_map(base, c / s.owner) : 0u;
    if (plain) {
      const uint32_t row_bytes = 4u * s.ld;
      for (int pr0 = lane % lpg; pr0 < kPairs; pr0 += kBatch * lpg) {
        float4 v[kBatch][2];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int pr = pr0 + b * lpg;
          const int r = (pr >> 3) * 16 + (pr & 7);  // the pair's rows r, r + 8
          v[b][0] = v[b][1] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (pr < kPairs && inside) {
            if (remote) {
              v[b][0] = ld_cluster4(at + row_bytes * r);
              v[b][1] = ld_cluster4(at + row_bytes * (r + 8));
            } else if (s.l2) {
              v[b][0] = __ldcg(reinterpret_cast<const float4*>(base + (size_t)r * s.ld));
              v[b][1] = __ldcg(reinterpret_cast<const float4*>(base + (size_t)(r + 8) * s.ld));
            } else {
              v[b][0] = *reinterpret_cast<const float4*>(base + (size_t)r * s.ld);
              v[b][1] = *reinterpret_cast<const float4*>(base + (size_t)(r + 8) * s.ld);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int pr = pr0 + b * lpg;
          if (pr < kPairs) store_pair<kBf16>(hi, lo, pr * 2 * sa + 8 * gq, v[b]);
        }
      }
      continue;
    }
    const bool vec = c + 4 <= s.K && (s.ld & 3) == 0 && aligned16(base) && c + 4 <= s.split;
    for (int pr = lane % lpg; pr < kPairs; pr += lpg) {
      const int r = (pr >> 3) * 16 + (pr & 7);
      float4 v[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
      if (inside && s.p2 != nullptr) {  // the step's [x, u]: float by float
        for (int h = 0; h < 2; ++h) {
          const int rr = r + 8 * h;
          if (rr >= s.valid) continue;
          float e[4];
          for (int q = 0; q < 4; ++q) {
            const int cc = c + q;
            e[q] = cc >= s.K ? 0.f
                   : cc < s.split ? s.p[(size_t)rr * s.ld + cc]
                                  : s.p2[(size_t)rr * s.ld2 + cc - s.split];
          }
          v[h] = make_float4(e[0], e[1], e[2], e[3]);
        }
      } else if (inside) {
        v[0] = load_act4(base, at, remote, s.l2, s.ld, r, s.valid, c, s.K, vec);
        v[1] = load_act4(base, at, remote, s.l2, s.ld, r + 8, s.valid, c, s.K, vec);
      }
      store_pair<kBf16>(hi, lo, pr * 2 * sa + 8 * gq, v);
    }
  }
}

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(kBytes)
                 : "memory");
  }
}

// The lane's cp.async copies so far arrive on `bar` once they have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// One TMA box of a 2-D tensor map: columns [c, c + 32) x rows [r, r + its
// box rows) into dst (1024-byte aligned), counted on `bar`.
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map, int c, int r,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c), "r"(r), "r"(smem_addr(bar))
      : "memory");
}

// `count` floats from src to dst by 4-byte cp.async, every lane a share.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int count, int lane) {
  for (int e = lane; e < count; e += kWarp) cp_async<4>(dst + e, src + e);
}

// Where row t of every k-step of a kRowsEach layer lies in its stage row:
// its 16-byte phase (rows t + 4 s share it, chunks start at multiples of 8
// rows), or 0 for the step's first layer, whose rows are copied float by
// float.
__device__ __forceinline__ int wide_shift(const WideLayer& d, bool split_first, int t) {
  return split_first ? 0 : (int)((reinterpret_cast<uintptr_t>(d.w) / 4 + (size_t)t * d.N) & 3);
}

// Weight rows [k0, k0 + n) of layer d into a stage's weight part, for the
// pass of pw columns from c0 (the header's weights; wide_mode `mode`, wf
// floats a row; with kLs the first layer's rows from `split` on come from
// Wtail), by the producer warp. Lane 0 arrives on `full` with the bulk and
// TMA bytes before any copy is issued; every lane's small copies arrive on
// it (cp_async_arrive, by the caller) once landed.
template <bool kLs>
__device__ __forceinline__ void stage_weights(float* dst, const WideLayer& d,
                                              const CUtensorMap* map, int mode, int wf,
                                              const float* __restrict__ Wtail, int split, int k0,
                                              int n, int c0, int pw, uint64_t* full, int lane) {
  const int N = d.N;
  const auto row = [&](int k) {
    return kLs && k >= split ? Wtail + (size_t)(k - split) * N : d.w + (size_t)k * N;
  };
  if (mode == kRowsBoxes) {
    const int boxes = (pw + kBoxCols - 1) / kBoxCols;
    if (lane == 0) mbar_arrive_expect_tx(full, boxes * kBoxCols * d.step * 4u);
    __syncwarp();
    for (int b = lane; b < boxes; b += kWarp) {
      tma_box(dst + b * kBoxCols * d.step, map, c0 + b * kBoxCols, k0, full);
    }
    return;
  }
  if (mode == kRowsWhole) {
    // one span of whole rows, two where the rows cross `split`
    const int head = kLs ? max(0, min(n, split - k0)) : n;
    const float* src[2] = {row(k0), row(k0 + head)};
    float* to[2] = {dst, dst + (size_t)head * N};
    const int count[2] = {head * N, (n - head) * N};
    int bulk[2];
    for (int i = 0; i < 2; ++i) {
      bulk[i] = count[i] > 0 && aligned16(src[i]) && aligned16(to[i]) ? count[i] & ~3 : 0;
    }
    if (lane == 0) mbar_arrive_expect_tx(full, (bulk[0] + bulk[1]) * 4u);
    __syncwarp();
    for (int i = 0; i < 2; ++i) {
      if (bulk[i] > 0 && lane == 0) bulk_copy(to[i], src[i], bulk[i] * 4u, full);
      copy_floats(to[i] + bulk[i], src[i] + bulk[i], count[i] - bulk[i], lane);
    }
    return;
  }
  // kRowsEach: a lane's rows, each a bulk copy of its aligned interior at its
  // phase; the step's first layer float by float
  const bool split_first = kLs && Wtail != nullptr;
  uint32_t bytes = 0;
  if (!split_first) {
    for (int r = lane; r < n; r += kWarp) {
      const int o = (int)((reinterpret_cast<uintptr_t>(row(k0 + r) + c0) / 4) & 3);
      const int head = min(pw, (4 - o) & 3);
      bytes += (uint32_t)(pw - head) / 4 * 16;
    }
  }
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) mbar_arrive_expect_tx(full, bytes);
  __syncwarp();
  if (split_first) {
    for (int r = 0; r < n; ++r) copy_floats(dst + r * wf, row(k0 + r) + c0, pw, lane);
    return;
  }
  for (int r = lane; r < n; r += kWarp) {
    const float* src = row(k0 + r) + c0;
    const int o = (int)((reinterpret_cast<uintptr_t>(src) / 4) & 3);
    const int head = min(pw, (4 - o) & 3), body = (pw - head) / 4 * 4;
    float* to = dst + r * wf + o;
    for (int e = 0; e < head; ++e) cp_async<4>(to + e, src + e);
    if (body > 0) bulk_copy(to + head, src + head, body * 4u, full);
    for (int e = head + body; e < pw; ++e) cp_async<4>(to + e, src + e);
  }
}

// A layer's columns of a hidden output are written (the consumers' side,
// after their stores) and may be read (the producers' side, before their
// loads). A cluster of one block meets at a named barrier of the block; a
// larger one at the cluster barrier, which the consumers arrive at and wait
// on only before their next arrival (`pending`).
__device__ __forceinline__ void hidden_written(int cluster, bool& pending) {
  if (cluster == 1) {
    asm volatile("bar.arrive 4, %0;" ::"n"(kWideThreads) : "memory");
    return;
  }
  if (pending) cluster_wait();
  cluster_arrive();
  pending = true;
}

__device__ __forceinline__ void hidden_ready(int cluster) {
  if (cluster == 1) {
    asm volatile("bar.sync 4, %0;" ::"n"(kWideThreads) : "memory");
    return;
  }
  cluster_arrive();
  cluster_wait();
}

// The wide path's start: producer warp 0 sets up the ring's barriers (a
// stage is full after kWideFullArrivals, from the one producer warp that
// fills it; empty after one arrival per consumer warp), the producer warps
// meet, tell the consumers without waiting for them, and go on to fill
// stages; the consumers meet them here (wide_consumers_start).
__device__ __forceinline__ void wide_producers_start(const Ring& ring) {
  if (threadIdx.x == kConsumers) {
    for (int s = 0; s < ring.stages; ++s) {
      mbar_init(ring.full + s, kWideFullArrivals);
      mbar_init(ring.empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("bar.sync 5, %0;" ::"n"(kWideProducers * kWarp) : "memory");
  asm volatile("bar.arrive 2, %0;" ::"n"(kWideThreads) : "memory");
}

__device__ __forceinline__ void wide_consumers_start() {
  asm volatile("bar.sync 2, %0;" ::"n"(kWideThreads) : "memory");
}

// The producer warps of a wide-path kernel for one row tile: every layer's
// passes over the block's columns, chunk by chunk, each stage the chunk's
// weight rows and the layer input's columns. Chunk q (counted over the
// block's whole walk, `q`) is producer warp q % kWideProducers's, in stage
// q % stages: the four warps, one an SM sub-partition, fill four stages at
// once, so that one chunk's loads from the peers fly while the others'
// do. A layer that reads a hidden output (buffer h & 1, then ++h) waits
// for it after the warp's first chunk's weights are on their way. x0: the
// first layer's input.
template <int TM, bool kLs, bool kBf16>
__device__ __forceinline__ void wide_produce(const Ring& ring, int& q, const WidePlan& plan,
                                             const WideTable& t, const ActSource& x0,
                                             float* const (&buf)[2], int& h, int rank) {
  const int lane = threadIdx.x % kWarp;
  const int me = (threadIdx.x - kConsumers) / kWarp;
  for (int l = 0; l < t.n_layers; ++l) {
    const WideLayer d = wide_layer(t, l);
    ActSource src = x0;
    bool ready = l == 0 && !kLs;  // the step's first layer waits for u
    if (l > 0) {
      // a cluster of one reads its own buffer as plain shared memory, a
      // streamed plan its cluster's whole rows in device memory
      const bool whole = plan.streamed || plan.cluster == 1;
      src = ActSource{buf[h & 1], plan.sb, TM, d.K, whole ? 0 : wide_layer(t, l - 1).cols,
                      nullptr, 0, d.K, plan.streamed != 0};
      ++h;
    }
    const float* tail = kLs && l == 0 ? t.w0_tail : nullptr;
    const int split = kLs && l == 0 ? t.split : d.K;
    const int mode = wide_mode(d, plan.pass_cols, kLs && l == 0);
    const int cb = rank * d.cols, ce = min(d.N, cb + d.cols);
    const int sa = d.step + 4;
    for (int c0 = cb; c0 < ce; c0 += plan.pass_cols) {
      const int pw = min(plan.pass_cols, ce - c0), wf = wide_row_floats(mode, pw, d.N);
      const int a_at = d.step * wf;  // the stage's input planes, after its weight rows
      for (int k0 = 0; k0 < d.K; k0 += d.step) {
        const int chunk = q++;
        if (chunk % kWideProducers != me) continue;
        const int s = chunk % ring.stages;
        const int n = min(d.step, d.K - k0), n8 = (n + 7) & ~7;
        float* st = ring.buf + (size_t)s * ring.stage_floats;
        // passes at once on the stage's first round
        mbar_wait_suspend(ring.empty + s, ((chunk / ring.stages) & 1) ^ 1);
        stage_weights<kLs>(st, d, wide_map(t, l), mode, wf, tail, split, k0, n, c0, pw,
                           ring.full + s, lane);
        cp_async_arrive(ring.full + s);
        // zero weight rows up to the k-step (TMA fills rows past K with
        // zeros itself): the input's pad columns are zeros too, and 0 x
        // (whatever the stage held) could be a NaN
        if (mode != kRowsBoxes) {
          for (int e = lane; e < (n8 - n) * wf; e += kWarp) st[n * wf + e] = 0.f;
        }
        if (!ready) {
          hidden_ready(plan.cluster);
          ready = true;
        }
        stage_acts<TM, kBf16>(st + a_at, sa, src, k0, n8, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.full + s);
      }
    }
    if (!ready) hidden_ready(plan.cluster);  // the warp filled no chunk of this layer
  }
}

// Where a wide pass's outputs go: the last layer's rows to y (ld floats a
// row from column c0; rows past `rows` are not stored), with kLs plus
// resid[r * resid_stride + c]; a hidden layer's, relu'd, to this block's
// buffer act (sb floats a row, from the pass's column).
struct WideOut {
  float* y;
  int ld;
  int row0, rows;
  const float* resid;
  int resid_stride;
  float* act;
  int sb;
  bool streamed;  // act lies in device memory, else in shared memory
};

// A hidden output into the buffer at p: by st.shared where the buffer is
// this block's shared memory (a generic store would cost an address
// translation), else a plain store.
__device__ __forceinline__ void store_act(float* p, float v, bool streamed) {
  if (streamed) {
    *p = v;
  } else {
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(smem_addr(p)), "f"(v));
  }
}

// Where a lane's B fragments lie in a stage (wide_b): row t's first at
// `at`, row t + 4's `half` floats on, the next k-step's `step8` on; the
// input planes from a_at.
struct WideB {
  int at, half, step8, a_at;
};

// WideB for lane (g, t) of a warp whose first column is `cs` in the pass (pw
// columns from c0 of a layer in `mode`, wf floats a stage row).
__device__ __forceinline__ WideB wide_b(const WideLayer& d, int mode, bool split_first, int wf,
                                        int c0, int cs, int t) {
  WideB w;
  w.a_at = d.step * wf;
  if (mode == kRowsWhole) {  // whole rows: the pass's columns from c0
    w.at = t * d.N + c0 + cs;
    w.half = 4 * d.N;
    w.step8 = 8 * d.N;
  } else if (mode == kRowsBoxes) {  // box cs / 32; 16-byte chunks swizzled by the row mod 8
    const int ch = (cs % kBoxCols) / 4;
    w.at = cs / kBoxCols * kBoxCols * d.step + t * kBoxCols + 4 * (ch ^ t) + cs % 4;
    w.half = 4 * kBoxCols + 4 * ((ch ^ (t + 4)) - (ch ^ t));
    w.step8 = 8 * kBoxCols;
  } else {  // rows at their phase
    w.at = t * wf + wide_shift(d, split_first, t) + cs;
    w.half = 4 * wf;
    w.step8 = 8 * wf;
  }
  return w;
}

// One pass of a layer for a warp that owns T 8-column tiles from column
// `base` of the pass on (T == 0: the warp only keeps the ring's pace): the
// chunks' products as they land, from the stage's planes and weight rows,
// the segments added in order, then the epilogue. The pass covers pw
// columns from c0 (of the layer; the bias is read from bias + c0).
template <int MT, int WM, int T, bool kVec, bool kLs, bool kBf16>
__device__ __forceinline__ void wide_tiles(const Ring& ring, RingPos& pos, const WideOut& o, int K,
                                           int step, int pw, const WideB& wb, int c0, int base,
                                           const float* __restrict__ bias, bool last) {
  constexpr int TM = 16 * MT * WM;
  constexpr int TT = T > 0 ? T : 1;
  const int lane = threadIdx.x % kWarp;
  const int wm = threadIdx.x / kWarp % WM;
  const int g = lane / 4, t = lane % 4;  // the fragment's row (column of B) and k pair
  const int col = base + 2 * t * T;      // the lane's first output column
  float acc[MT][TT][4], b[TT][2];
#pragma unroll
  for (int j = 0; j < TT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col + e * T + j;
      b[j][e] = T > 0 && c < pw ? __ldg(bias + c0 + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  const int sa = step + 4;
  const int a_at = wb.a_at + act_index(wm * MT * 16 + g, t, sa);
  const int w_at = wb.at;
  float done[T > 0 ? MT : 1][TT][4];  // the segments before this one
  bool folded = false;
  for (int k0 = 0; k0 < K; k0 += step) {
    const int n = min(step, K - k0);
    mbar_wait_suspend(ring.full + pos.s, pos.phase);
    if constexpr (T > 0) {
      const float* st = ring.buf + (size_t)pos.s * ring.stage_floats;
      chunk_products_at<MT, T, kVec, kBf16>(acc, st + a_at, st + TM * sa + a_at, sa, st + w_at,
                                            wb.half, wb.step8, (n + 7) & ~7);
      if (k0 + step < K && (k0 + step) % kSegmentRows == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < TT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              done[i][j][e] = folded ? done[i][j][e] + acc[i][j][e] : acc[i][j][e];
              acc[i][j][e] = 0.f;
            }
          }
        }
        folded = true;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty + pos.s);
    if (++pos.s == ring.stages) {
      pos.s = 0;
      pos.phase ^= 1;
    }
  }
  if constexpr (T > 0) {
    if (folded) {  // the segments before, then the last
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < TT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = done[i][j][e] + acc[i][j][e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * MT + i) * 16 + g + 8 * h;
        if (last && o.row0 + r >= o.rows) continue;
#pragma unroll
        for (int j = 0; j < T; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = col + e * T + j;
            if (c >= pw) continue;
            const float v = acc[i][j][2 * h + e] + b[j][e];
            if (last) {
              o.y[(size_t)(o.row0 + r) * o.ld + c0 + c] =
                  kLs ? v + o.resid[r * o.resid_stride + c0 + c] : v;
            } else {
              store_act(o.act + r * o.sb + c, fmaxf(v, 0.f), o.streamed);
            }
          }
        }
      }
    }
  }
}

// One pass for the consumer warps, WM row groups x WN column groups: the
// pass's 8-column tiles dealt to the column groups in runs of ceil(tiles /
// WN), as MLP_CONSUME_COLS deals them (runs of 3 as runs of 4 where the
// weights come in 32-column boxes: a run then never spans two boxes); B
// fragments by vector loads unless a stage row's columns lie unaligned
// (whole rows with N % 4 != 0, or rows at their phase). Expands where
// ring, pos, o, d, mode, split_first, wf, pw, c0 and last are in scope.
#define WIDE_CONSUME_PASS(MT, WM, kLs, kBf16)                                                   \
  do {                                                                                         \
    constexpr int WN = kConsumerWarps / (WM);                                                  \
    const int wn = threadIdx.x / kWarp / (WM);                                                 \
    const int tiles = (pw + 7) / 8;                                                            \
    int tb = (tiles + WN - 1) / WN;                                                            \
    if (mode == kRowsBoxes && tb == 3) tb = 4;                                                 \
    const int base = wn * tb * 8;                                                              \
    const int mine = max(0, min(tb, tiles - wn * tb));                                         \
    const WideB wb = wide_b(d, mode, split_first, wf, c0, base + threadIdx.x % kWarp / 4 * mine, \
                            threadIdx.x % 4);                                                  \
    const bool vec = mode == kRowsBoxes || (mode == kRowsWhole && d.N % 4 == 0) ||             \
                     (mode == kRowsEach && split_first);                                       \
    if (vec) {                                                                                 \
      switch (mine) {                                                                          \
        case 0: WIDE_TILES(MT, WM, 0, true, kLs, kBf16); break;                                \
        case 1: WIDE_TILES(MT, WM, 1, true, kLs, kBf16); break;                                \
        case 2: WIDE_TILES(MT, WM, 2, true, kLs, kBf16); break;                                \
        case 3: WIDE_TILES(MT, WM, 3, true, kLs, kBf16); break;                                \
        default: WIDE_TILES(MT, WM, kWarpTiles, true, kLs, kBf16); break;                      \
      }                                                                                        \
    } else {                                                                                   \
      switch (mine) {                                                                          \
        case 0: WIDE_TILES(MT, WM, 0, false, kLs, kBf16); break;                               \
        case 1: WIDE_TILES(MT, WM, 1, false, kLs, kBf16); break;                               \
        case 2: WIDE_TILES(MT, WM, 2, false, kLs, kBf16); break;                               \
        case 3: WIDE_TILES(MT, WM, 3, false, kLs, kBf16); break;                               \
        default: WIDE_TILES(MT, WM, kWarpTiles, false, kLs, kBf16); break;                     \
      }                                                                                        \
    }                                                                                          \
  } while (0)
#define WIDE_TILES(MT, WM, T, V, kLs, kBf16) \
  wide_tiles<MT, WM, T, V, kLs, kBf16>(ring, pos, o, d.K, d.step, pw, wb, c0, base, d.b, last)

// The consumer warps of a wide-path kernel for one row tile: each layer's
// passes over the block's columns; a hidden layer's output to buffer h & 1
// (then ++h), and the producers told once it is written (hidden_written;
// `pending`: a cluster barrier arrival not yet waited on); the last layer's
// rows to y as in mlp_consume.
template <int MT, int WM, bool kLs, bool kBf16>
__device__ __forceinline__ void wide_consume(const Ring& ring, RingPos& pos, const WidePlan& plan,
                                             const WideTable& t, float* const (&buf)[2], int& h,
                                             bool& pending, int rank, float* __restrict__ y,
                                             int row0, int rows, const float* resid,
                                             int resid_stride) {
  for (int l = 0; l < t.n_layers; ++l) {
    const WideLayer d = wide_layer(t, l);
    const bool last = l == t.n_layers - 1;
    const bool split_first = kLs && l == 0;
    const int mode = wide_mode(d, plan.pass_cols, split_first);
    const int cb = rank * d.cols, ce = min(d.N, cb + d.cols);
    for (int c0 = cb; c0 < ce; c0 += plan.pass_cols) {
      const int pw = min(plan.pass_cols, ce - c0), wf = wide_row_floats(mode, pw, d.N);
      float* act = buf[h & 1] + (plan.streamed ? c0 : c0 - cb);  // the pass's first column
      const WideOut o{y, d.N, row0, rows, resid, resid_stride, act, plan.sb, plan.streamed != 0};
      WIDE_CONSUME_PASS(MT, WM, kLs, kBf16);
    }
    if (!last) {
      hidden_written(plan.cluster, pending);
      ++h;
    }
  }
}

// The cluster's last round: no block leaves while a peer may read its
// shared memory. `pending` as in wide_consume (false for the producer).
__device__ __forceinline__ void wide_finish(int cluster, bool pending) {
  if (cluster == 1) return;
  if (pending) cluster_wait();
  cluster_arrive();
  cluster_wait();
}

}  // namespace
