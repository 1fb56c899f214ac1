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

#include <cuda_bf16.h>

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
constexpr int kOutSegments = 2;   // layer_tiles' kOut on the wide path (forward and recompute)
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
// base + g * T of the k-step.
template <int T, bool kVec>
__device__ __forceinline__ void load_b(float (&b)[T][2], const float* __restrict__ w, int N) {
  if constexpr (kVec && T == 4) {
    const float4 r0 = *reinterpret_cast<const float4*>(w);
    const float4 r1 = *reinterpret_cast<const float4*>(w + 4 * N);
    b[0][0] = r0.x, b[1][0] = r0.y, b[2][0] = r0.z, b[3][0] = r0.w;
    b[0][1] = r1.x, b[1][1] = r1.y, b[2][1] = r1.z, b[3][1] = r1.w;
  } else if constexpr (kVec && T == 2) {
    const float2 r0 = *reinterpret_cast<const float2*>(w);
    const float2 r1 = *reinterpret_cast<const float2*>(w + 4 * N);
    b[0][0] = r0.x, b[1][0] = r0.y;
    b[0][1] = r1.x, b[1][1] = r1.y;
  } else {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      b[j][0] = w[j];
      b[j][1] = w[4 * N + j];
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
                                              const float* __restrict__ w, int N) {
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
  load_b<T, kVec>(b0, w, N);
  if constexpr (kFull) load_b<T, kVec>(b1, w + 8 * N, N);
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
// floats per row pair) times B (load_b's layout, `rows` weight rows of
// length N). T is a template argument so that the loop has no branch:
// the loads of a k-step then issue together and ahead of the products that
// need them, where a test per tile would make each tile wait for its own
// loads in turn. With kBf16 the a_hi plane holds bfloat16 values, B is
// rounded to bfloat16 and each pair of k-steps is one bf16 product
// (bf16_products).
template <int MT, int T, bool kVec, bool kBf16>
__device__ __forceinline__ void chunk_products(float (&acc)[MT][T][4],
                                               const float* __restrict__ a_hi,
                                               const float* __restrict__ a_lo, int sa,
                                               const float* __restrict__ w, int N, int rows) {
  if constexpr (kBf16) {
    // the 16-row tile's loop unrolled twice, the 64-row tile's not: each
    // the faster on the card (PERF.md, section 6)
    int k = 0;
    if constexpr (MT == 1) {
#pragma unroll 2
      for (; k + 16 <= rows; k += 16) {
        bf16_products<MT, T, kVec, true>(acc, a_hi, sa, w, N);
        a_hi += 32;
        w += 16 * N;
      }
    } else {
#pragma unroll 1
      for (; k + 16 <= rows; k += 16) {
        bf16_products<MT, T, kVec, true>(acc, a_hi, sa, w, N);
        a_hi += 32;
        w += 16 * N;
      }
    }
    if (k < rows) bf16_products<MT, T, kVec, false>(acc, a_hi, sa, w, N);
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
    load_b<T, kVec>(b, w, N);
    a_hi += 16;
    a_lo += 16;
    w += 8 * N;
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

// Where a consumer warp stands in the ring.
struct RingPos {
  int s = 0;
  uint32_t phase = 0;
};

// What mlp_consume hands a layer: the output and the residual; and, for a
// caller that keeps every layer's input (kOut: the backward kernel's
// recompute, the wide path's two pairs of planes), the planes a hidden
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
// kOut == kOutSegments (the wide path: the forward kernels' passes and the
// backward's recompute) also takes the contraction over K in segments:
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
// The wide path: stacks of any depth and width.
//
// A stack deeper than kInlineLayers, or one the path above does not take (a
// layer wider than one pass of the warps' columns, or planes that do not
// fit beside the ring in a block's shared memory), runs through the same
// products, fragments, epilogue and ring, with four differences.
//  * Passes. A layer wider than P = 32 * WN columns (512 on the 16-row
//    tile, 256 on the 64-row tile) is computed in passes of P columns, each
//    a run of layer_tiles over all K rows. The ring then carries column
//    slabs: a chunk of weight rows [k0, k0 + n) x columns [c0, c0 + P) is n
//    spans of one row each, laid P floats apart in the stage (a bulk copy
//    a row). A layer of at most P columns keeps whole rows, one span a
//    chunk, as above.
//  * Two pairs of planes. A pass writes its columns while later passes
//    still read the whole input, so a layer's output goes to a second pair
//    of planes (kOut), and the pairs swap at every layer.
//  * Where the planes live. Both pairs (and the line-search step's f32
//    input rows) sit in shared memory where they fit beside a ring of
//    kMinStages stages; else in the block's slot of a device workspace that
//    the caller allocates (the TPU kernel kept its whole tile in VMEM,
//    megabytes; here a slot is read by one SM, mostly from L1 and L2). The
//    planes' pointer is made opaque to the compiler, so every access is a
//    generic load or store and none goes through the read-only cache, which
//    does not see what the block itself wrote.
//  * Segments. The contraction over a layer's K rows is summed in
//    segments of kSegmentRows rows, added in order (layer_tiles,
//    kOutSegments): a layer of at most 512 rows has one.
// A block walks row tiles gridDim.x apart, at most one block an SM, so the
// workspace holds as many slots as blocks; its producer warp streams the
// weights again for each tile. The layers come from a table in device
// memory (MlpTable), any number of them. The arithmetic is the path
// above's: the same products in the same k order, epilogue and rounding,
// the segments' sums aside.

struct WidePlan {
  int sa;              // the planes' row stride, floats: = 4 (mod 8)
  int pass_cols;       // P
  int extra_floats;    // the caller's own buffer
  int stage_floats;    // floats per ring stage
  int stages;
  int planes_smem;     // 1: both pairs of planes in shared memory; 0: in the block's slot
  int extra_smem;      // the same for the caller's buffer
  size_t slot_floats;  // the block's slot of the workspace
  size_t smem;         // bytes
};

// Lay out a stack (layers[l].K, .N) for the wide path at tile_rows rows
// and pass_cols columns a pass, and set each layer's step. Places tried in
// order: the planes and the caller's buffer in shared memory, the buffer
// alone, neither; at each, the deepest ring of 64-, 32-, 16- or 8-row
// stages (of the widest pass) of which kMinStages fit. The last place
// always fits: a ring of 3 stages of 8 rows of 512 floats is 48 KB.
inline void plan_wide(LayerDesc* layers, int n_layers, int tile_rows, int pass_cols,
                      int extra_floats, WidePlan* p) {
  int widest = layers[0].K, widest_out = 0;
  for (int l = 0; l < n_layers; ++l) {
    widest = max(widest, layers[l].N);
    widest_out = max(widest_out, layers[l].N);
  }
  p->sa = ((widest + 7) & ~7) + 4;
  p->pass_cols = pass_cols;
  p->extra_floats = (extra_floats + 3) & ~3;
  const int stride = min((widest_out + 3) & ~3, pass_cols);
  const size_t planes = 4ull * tile_rows * p->sa;
  for (int place = 0; place < 3; ++place) {
    p->planes_smem = place == 0;
    p->extra_smem = place < 2;
    const size_t fixed =
        kBarrierBytes + ((p->planes_smem ? planes : 0) + (p->extra_smem ? p->extra_floats : 0) + 8) *
                            sizeof(float);
    for (int rows = 64; rows >= 8; rows /= 2) {
      p->stage_floats = rows * stride;
      const size_t stage = p->stage_floats * sizeof(float);
      if (fixed + kMinStages * stage > kMaxSmem) continue;
      p->stages = (int)min((size_t)kMaxStages, (kMaxSmem - fixed) / stage);
      p->smem = fixed + p->stages * stage;
      p->slot_floats = (p->planes_smem ? 0 : planes) + (p->extra_smem ? 0 : p->extra_floats);
      for (int l = 0; l < n_layers; ++l) {
        layers[l].step = (p->stage_floats / min(layers[l].N, pass_cols)) & ~7;
      }
      return;
    }
  }
}

// The wide path's workspace: the layer table at its head, then `blocks`
// slots of `slot_floats`. Where `work_bytes` is less than that, sets
// *work_needed and returns -2, launching nothing; else copies the table in
// on `stream` (from pageable memory: staged before the call returns) and
// returns 0 with the first slot in *slots, or a cudaError_t value.
inline int wide_workspace(const std::vector<LayerDesc>& table, size_t blocks, size_t slot_floats,
                          void* work, size_t work_bytes, size_t* work_needed,
                          cudaStream_t stream, float** slots) {
  const size_t head = table_bytes(table.size());
  const size_t need = head + blocks * slot_floats * sizeof(float);
  if (work_bytes < need) {
    *work_needed = need;
    return -2;
  }
  *slots = reinterpret_cast<float*>(static_cast<unsigned char*>(work) + head);
  return (int)cudaMemcpyAsync(work, table.data(), table.size() * sizeof(LayerDesc),
                              cudaMemcpyHostToDevice, stream);
}

// The generic pointer p, of which the compiler knows nothing more.
__device__ __forceinline__ float* opaque(float* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// A wide-path block's tile: the layer's input planes (in.hi, in.lo), the
// caller's buffer and the ring, and the output planes.
struct WideTile {
  Tile in;
  float* o_hi;
  float* o_lo;
};

// Shared memory: [mbarriers][planes, if there][buffer, if there][ring + 8];
// the block's slot of the workspace: [planes, if there][buffer, if there].
__device__ __forceinline__ WideTile carve_wide(unsigned char* smem, const WidePlan& p,
                                               int tile_rows, float* slot) {
  WideTile t;
  t.in.ring.full = reinterpret_cast<uint64_t*>(smem);
  t.in.ring.empty = t.in.ring.full + kMaxStages;
  float* f = reinterpret_cast<float*>(smem + kBarrierBytes);
  const size_t plane = (size_t)tile_rows * p.sa;
  float* planes;
  if (p.planes_smem) {
    planes = f;
    f += 4 * plane;
  } else {
    planes = slot;
    slot += 4 * plane;
  }
  float* extra;
  if (p.extra_smem) {
    extra = f;
    f += p.extra_floats;
  } else {
    extra = slot;
  }
  planes = opaque(planes);
  t.in.hi = planes;
  t.in.lo = planes + plane;
  t.o_hi = planes + 2 * plane;
  t.o_lo = planes + 3 * plane;
  t.in.extra = opaque(extra);
  t.in.ring.buf = f;
  t.in.ring.stage_floats = p.stage_floats;
  t.in.ring.stages = p.stages;
  return t;
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

// One layer into the ring in the order the wide consumers read it: a layer
// of at most pass_cols columns as produce_rows streams it, a wider one pass
// by pass, each chunk a column slab pass_cols floats a row (the last
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

// The producer warp of a wide-path forward, for one row tile: every
// layer's weights in the order wide_consume reads them.
template <bool kLs>
__device__ __forceinline__ void wide_produce(const Ring& ring, ProducerPos& pp,
                                             const MlpTable& args, int pass_cols) {
  for (int l = 0; l < args.n_layers; ++l) {
    const LayerDesc d = args.layer[l];
    produce_layer_wide<kLs>(ring, pp, d, kLs && l == 0 ? args.w0_tail : nullptr,
                            kLs && l == 0 ? args.split : d.K, pass_cols);
  }
}

// The consumer warps of a wide-path forward, for one row tile whose input
// rows are in t.in's planes (as mlp_consume takes them): each layer pass by
// pass into the other pair of planes, which then becomes the input; the
// last layer's rows to y as in mlp_consume. `pos` carries over from tile to
// tile, as the producer's ring does.
template <int MT, int WM, bool kLs, bool kBf16>
__device__ __forceinline__ void wide_consume(const WideTile& t, RingPos& pos, const MlpTable& args,
                                             const WidePlan& plan, float* __restrict__ y,
                                             int row0, int rows, const float* resid,
                                             int resid_stride) {
  Tile tile = t.in;
  float* o_hi = t.o_hi;
  float* o_lo = t.o_lo;
  for (int l = 0; l < args.n_layers; ++l) {
    const LayerDesc d = args.layer[l];
    const int K = d.K, N = d.N;
    const bool last = l == args.n_layers - 1;
    const TileIo io{plan.sa, y, row0, rows, resid, resid_stride, o_hi, o_lo, plan.sa};
    const int S = min(N, plan.pass_cols);
    for (int c0 = 0; c0 < N; c0 += plan.pass_cols) {
      const int cols = min(plan.pass_cols, N - c0);
      MLP_CONSUME_COLS(MT, WM, kLs, kOutSegments, kBf16, d.step, d.b, cols, S, c0, N);
    }
    float* h = tile.hi;
    tile.hi = o_hi;
    o_hi = h;
    h = tile.lo;
    tile.lo = o_lo;
    o_lo = h;
  }
}

}  // namespace
