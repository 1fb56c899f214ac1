// Fused relu-MLP backward for Hopper (sm_90a): tensor-core products at f32
// accuracy.
//
// Replaces gan_mpc_tpu/ops/fused_mlp.py::_bwd_kernel: given x (rows, fin),
// the output cotangent g (rows, fout) and the stack's weights, it
// recomputes the forward, then walks the layers backwards:
//   dW_l = a_l^T g_{l+1},  db_l = sum_rows g_{l+1},
//   g_l  = (g_{l+1} W_l^T) * (a_l > 0)   (no mask for l = 0: dx = g_0),
// where a_0 = x and a_l = relu(layer l-1) are the layer inputs. Weights
// are (in, out) row-major, the JAX package's kernel layout.
//
// What bounds it on an H100: the dx chain and dW take a product per
// layer, the recompute one per layer but the last (dW_{L-1} needs only the
// last layer's input): 2 x rows x (2 sum_l d_l d_{l+1} + sum_{l<L-1}
// d_l d_{l+1}) operations against the rows, the weights and the
// gradients once, so the tensor-core rate bounds it at every size (three
// TF32 passes per f32-accurate product, 165 TFLOP/s at best). At the
// trainer's call (128 rows of the 23->200->200->200->17 dynamics stack)
// that is 67 MFLOP on 8 tiles of 16 rows, each of which walks the stack
// three times: one SM's instruction issue and latencies bound the call,
// as in the forward at 512 rows and fewer (scripts/diag_torch_bwd_phases.py
// prints the clocks of every phase).
//
// Design (products, fragments and the weight ring are the forward
// kernels', mlp_tile_mma.cuh):
//  * One block of 16 consumer warps and a producer warp owns tiles of 16
//    rows (the least an m16 product takes: 128 rows are 8 tiles), and
//    keeps EVERY layer's input of the tile in shared memory, split into a
//    hi and a lo TF32 plane in act_index's layout, each layer at its own
//    row stride (the 23-wide input takes 36 floats a row, not 212). Once
//    16-row tiles would take more than two waves of blocks, and the
//    stack's planes fit twice, tiles are 32 rows (MT = 2): a weight
//    fragment then serves two row blocks and dW's read-add-write of the
//    workspace, which is device-memory traffic at that size, halves. A
//    64-row tile of all layers' planes does not fit in a block's 227 KB.
//  * Recompute: layer_tiles, the forward's own loop, with each layer's
//    output written to the next layer's planes: the same arithmetic in the
//    same k order as fused_mlp_fwd, so the relu masks are the forward's.
//  * dW_l = a_l^T g: mma.sync m16n8k8 with the contraction over the tile's
//    rows (2 k-steps per 16). Planes interleave rows r and r + 8, so with
//    the k index of a step running over rows (4 s + t, 4 s + t + 8) both
//    the A fragment (a_l read transposed) and the B fragment (g) are
//    8-byte loads, free of bank conflicts at the planes' strides (= 4 mod
//    8). Both operands lie split in their planes: no arithmetic but the
//    products. A warp keeps a 16-row block of dW's A fragments and sweeps
//    g's 8-column tiles four at a time, adding into the slice of the
//    workspace (the first tile writes); the same lane owns the same
//    entries on every tile, so the read-add-write needs no barrier. db is
//    a column sum of hi + lo in f32. dW is the largest part of a tile's
//    time, so where a call has fewer tiles than a fourth of the SMs, up to
//    four blocks share a tile: each repeats the recompute and the chain
//    and takes a share of dW's warps' work (128 rows: 32 blocks).
//  * dx chain g W_l^T: the B fragment of mma.sync is a plain load, so W^T
//    is read from W as it lies (B[k][n] = W[n][k]): nothing is transposed.
//    A warp owns output columns of g_l, that is ROWS of W_l, and the
//    contraction runs over W_l's columns. A chunk of a row-major matrix
//    that holds all rows but few columns is one short span per row, and
//    feeding such slabs through the ring by one producer warp (a bulk copy
//    or 16-byte cp.async copies per span) took 22,000 clocks a 200 x 200
//    layer against 8,000 for its products; streaming W by whole rows would
//    give each chunk to the few warps that own its rows, one after the
//    other. So the chain's weights do not pass through shared memory: a
//    lane loads its fragments from device memory (L2) itself, 16 bytes a
//    tile and 16 columns, up to four rounds ahead of the products
//    (chain_tiles).
//    The masked result overwrites a_l's planes in place (a lane reads the
//    mask where it writes; dW_l, the only other reader of a_l, is done by
//    then), so the cotangent needs no planes of its own beyond the small
//    (16, fout) input. The mask is a_l's hi part > 0.
//  * The ring carries the recompute's weights and runs across the block's
//    tiles: the next tile's first chunks land during this tile's dW and
//    chain. Weights are read from device memory anew at every launch (the
//    optimizer updates them in place).
//  * The cross-tile sum of dW and db. The TPU kernel's grid runs in order,
//    so its first tile writes and later tiles add. Blocks of a GPU grid run
//    concurrently, so here the sum is a deterministic two-pass reduction:
//    there are at most as many slices as SMs, slice s is the sum of tiles
//    s, s + slices, ... (kept by the block, or the up to four blocks, that
//    walk them) in a part of a workspace, and a second kernel then adds
//    the slices in order. No atomics, so every run gives the same bits.
//    With one slice (a single tile) its blocks write the outputs directly.
//  * The ragged last tile is masked: rows past `rows` load zeros for x
//    and g, so they add nothing to dW and db, and their dx is not stored.
//    Widths that are no multiple of 8 are padded with zeros in shared
//    memory only; padded rows and columns of dW, db and dx are never
//    stored.
//  * The shared-memory path above takes a stack of at most kInlineLayers
//    layers, each at most kChainCols (512) wide, whose planes and a ring
//    of at least 3 stages of 8 rows of the widest hidden layer fit in
//    232,448 bytes (plan_bwd): the dynamics (23->200^3->17), 256-wide
//    (23->256^3->17), cost (17->128->128->10) and humanoid-class
//    (41->200^3->29) stacks, 23->512->512->17 and up to seven 200-wide
//    hidden layers.
//  * Any other stack (three 512-wide or six 256-wide hidden layers, 1024
//    wide, 32 layers) takes the wide path (fused_mlp_bwd_wide_kernel,
//    plan_bwd_wide): the same walk, products and reduction, with every
//    layer's planes laid out as above but in the block's slot of a device
//    workspace (2 x tile rows x the sum of the padded widths floats, plus
//    kSlotSlack for dW's reads past the last plane) unless they fit in
//    shared memory beside the ring; the recompute and the dx chain in
//    passes of kChainCols columns (the recompute's weights through the
//    ring as column slabs, the forward's wide path); and the layers'
//    widths, plane offsets and gradient offsets read from a table in
//    device memory, so no constant bounds the depth. The workspace and
//    the table are the caller's (fused_mlp_bwd returns -2 with the bytes
//    it needs); the slices and their fixed-order sum stay as above, so the
//    wide path too gives the same bits on every run.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or -1 for arguments it refuses).

#include "mlp_tile_mma.cuh"

#include <limits.h>

namespace {

constexpr int kSumThreads = 256;
constexpr int kMaxShares = 4;  // thread blocks that share a tile's dW, at most
constexpr int kStageRows[] = {64, 48, 32, 24, 16, 8};  // ring stage depths, deepest first
constexpr int kChainCols = kConsumerWarps * 8 * kWarpTiles;  // a chain pass's columns
constexpr int kSlotSlack = 256;  // floats past a slot's planes that dW's reads may touch

// With -DBWD_CLOCKS the first consumer thread of block 0 stamps the SM's
// clock after each phase of each of its tiles (scripts/diag_torch_bwd_phases.py
// builds that variant and reads the stamps through fused_mlp_bwd_clocks).
#ifdef BWD_CLOCKS
constexpr int kMaxStamps = 256;
__device__ long long bwd_stamps[kMaxStamps];
__device__ int bwd_stamp_count;
#define BWD_STAMP()                                                          \
  do {                                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0 && n_stamps < kMaxStamps) {      \
      bwd_stamps[n_stamps++] = clock64();                                    \
      bwd_stamp_count = n_stamps;                                            \
    }                                                                        \
  } while (0)
#else
#define BWD_STAMP() do {} while (0)
#endif

struct BwdArgs {
  const float* x;   // (rows, dims[0])
  const float* g;   // (rows, dims[L])
  float* dx;        // (rows, dims[0])
  float* part;      // (slices, stride): each slice the sum of its blocks' tiles
  int rows;
  int total;                // floats of one gradient set: dW_0, db_0, dW_1, ...
  int stride;               // floats from one slice to the next: total padded to 4, so that
                            // every slice is aligned like the first
  int shares;               // blocks that share a slice's tiles, each with a part of dW
  int offset[kInlineLayers];  // where dW_l starts in a set; db_l follows it (MlpArgs' path)
};

// A block's shared memory: [mbarriers][layer 0's hi, lo planes] ...
// [layer L-1's][the output cotangent's][ring + 8].
struct BwdPlan {
  int sa[kInlineLayers + 1];  // row stride of layer l's input planes (l = L: of the output
                              // cotangent's): the width padded to 16, plus 4
  int at[kInlineLayers + 1];  // where the hi plane starts, floats; the lo plane follows it
  int ring_at;
  int stage_floats;
  int stages;
  int step[kInlineLayers];    // recompute: weight rows per chunk of layer l
  size_t smem;                // bytes
};

// Lay the stack out for tiles of tile_rows (16 or 32) rows: the deepest of
// 64-, 48-, 32-, 24-, 16- or 8-row stages (at the widest layer the
// recompute streams) of which at least kMinStages fit beside the planes.
// A plane's row holds its layer's width padded to 16 columns (the chain
// contracts 16 at a time; the pad stays zero), plus 4 for the bank rule
// of act_index. Every width must be one pass of the warps' columns
// (kChainCols): the recompute and the chain deal a layer out once.
inline bool plan_bwd(const MlpArgs& a, int tile_rows, BwdPlan* p) {
  const int L = a.n_layers;
  int floats = 0, widest_out = 4;
  for (int l = 0; l <= L; ++l) {
    if (a.dims[l] > kChainCols) return false;
    p->sa[l] = ((a.dims[l] + 15) & ~15) + 4;
    p->at[l] = floats;
    floats += 2 * tile_rows * p->sa[l];
    if (l > 0 && l < L) widest_out = max(widest_out, a.dims[l]);
  }
  p->ring_at = floats;
  const size_t fixed = kBarrierBytes + (floats + 8ull) * sizeof(float);
  for (int rows : kStageRows) {
    p->stage_floats = rows * ((widest_out + 3) & ~3);
    const size_t stage = p->stage_floats * sizeof(float);
    if (fixed + kMinStages * stage > kMaxSmem) continue;
    for (int l = 0; l + 1 < L; ++l) p->step[l] = (p->stage_floats / a.dims[l + 1]) & ~7;
    p->stages = (int)min((size_t)kMaxStages, (kMaxSmem - fixed) / stage);
    p->smem = fixed + p->stages * stage;
    return true;
  }
  return false;
}

// The producer warp: per tile of the block, the recompute's row chunks
// in the order the consumers read them. (The chain reads its weights
// from device memory itself.)
__device__ __forceinline__ void bwd_produce(const Ring& ring, const MlpArgs& mlp,
                                            const BwdPlan& plan, int n_tiles, int shares) {
  ProducerPos pp;
  for (int tile = blockIdx.x / shares; tile < n_tiles; tile += gridDim.x / shares) {
    for (int l = 0; l + 1 < mlp.n_layers; ++l) {
      const int K = mlp.dims[l];
      produce_rows<false>(ring, pp, mlp.w[l], nullptr, K, K, mlp.dims[l + 1], plan.step[l]);
    }
  }
}

// The wide path's layout, for a stack the path above does not take (deeper
// than kInlineLayers, or whose planes and ring do not fit in shared
// memory): the ring in shared memory, of the deepest 64-, 48-, ..., 8-row
// stages (of the widest recompute pass, at most kChainCols floats a row) of
// which kMinStages fit; every layer's planes, laid out as plan_bwd lays
// them (LayerDesc sa and at; the output cotangent's in entry L), in shared
// memory where they fit beside such a ring, else in the block's slot of the
// workspace. Sets each layer's sa, at, offset and recompute step.
struct WideBwdPlan {
  int stage_floats;
  int stages;
  int planes_smem;     // 1: the planes in shared memory; 0: in the block's slot
  int plane_floats;    // all layers' planes
  size_t slot_floats;  // the block's slot: the planes and kSlotSlack, where not in shared memory
  size_t smem;         // bytes
};

inline void plan_bwd_wide(LayerDesc* t, int L, int tile_rows, WideBwdPlan* p) {
  int floats = 0, offset = 0, widest_out = 4;
  for (int l = 0; l <= L; ++l) {
    const int d = l < L ? t[l].K : t[L - 1].N;
    t[l].sa = ((d + 15) & ~15) + 4;
    t[l].at = floats;
    floats += 2 * tile_rows * t[l].sa;
    if (l < L) {
      t[l].offset = offset;
      offset += t[l].K * t[l].N + t[l].N;
    }
    if (l > 0 && l < L) widest_out = max(widest_out, d);
  }
  p->plane_floats = floats;
  const int stride = min((widest_out + 3) & ~3, kChainCols);
  for (int place = 0; place < 2; ++place) {
    p->planes_smem = place == 0;
    const size_t fixed =
        kBarrierBytes + ((p->planes_smem ? (size_t)floats : 0) + 8) * sizeof(float);
    for (int rows : kStageRows) {
      p->stage_floats = rows * stride;
      const size_t stage = p->stage_floats * sizeof(float);
      if (fixed + kMinStages * stage > kMaxSmem) continue;
      p->stages = (int)min((size_t)kMaxStages, (kMaxSmem - fixed) / stage);
      p->smem = fixed + p->stages * stage;
      p->slot_floats = p->planes_smem ? 0 : (size_t)floats + kSlotSlack;
      for (int l = 0; l + 1 < L; ++l) t[l].step = (p->stage_floats / min(t[l].N, kChainCols)) & ~7;
      return;
    }
  }
}

// Whether a warp's group of four tiles from tile0 on lies wholly inside
// the layer, for all the lanes' rows, and its entries go in aligned pairs.
__device__ __forceinline__ bool dw_whole(bool vec, int m0, int tile0, int tile_end, int K,
                                         int N) {
  return vec && (tile0 + kWarpTiles) * 8 <= N && tile0 + kWarpTiles <= tile_end && m0 + 16 <= K;
}

// The lane's entries of dW's sums so far for the group of tiles from tile0
// on, `out` pointing at the first (row m0 + g, column 8 tile0 + 2 t): rows
// +0 and +8, columns 2 t, 2 t + 1 of each tile; zeros outside the layer.
__device__ __forceinline__ void dw_load_sums(float (&v)[kWarpTiles][4], const float* out, int K,
                                             int N, bool vec, int m0, int tile0, int tile_end,
                                             int t, const bool (&row_live)[2]) {
  if (dw_whole(vec, m0, tile0, tile_end, K, N)) {
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 old = *reinterpret_cast<const float2*>(out + (size_t)8 * h * N + 8 * j);
        v[j][2 * h] = old.x, v[j][2 * h + 1] = old.y;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = (tile0 + j) * 8 + 2 * t + e % 2;
      const bool live = tile0 + j < tile_end && row_live[e / 2] && col < N;
      v[j][e] = live ? out[(size_t)8 * (e / 2) * N + 8 * j + e % 2] : 0.f;
    }
  }
}

// This tile's share of dW (K, N) = a^T g and db (N) = sum_rows g, written
// to dst (dW, then db) when `first`, else added to it. a (16, K) and g
// (16, N) lie split in planes of row strides sa and sg. k-step s
// contracts over the rows 4 s + t and 4 s + t + 8 of the tile's 16-row
// block s / 2 (s % 2 for the 4 s), a row pair of the planes, so every
// fragment register pair is one 8-byte load. A warp
// owns 16-row blocks of dW (16 columns of a): it keeps their A fragments
// in registers and sweeps g's 8-column tiles four at a time, so that the
// sweep is B loads, products and the read-add-write, with every address
// an offset from a pointer that moves with the sweep (the loop is bound by
// instruction issue, not by the products). Where a layer has fewer
// blocks than there are warps (cost: 8, the first layer: 2), a block's
// tiles are shared out between several warps; and where the call has
// fewer tiles than the card has SMs, `shares` thread blocks work on one
// tile, each with a share of these warps' work and block 0 with db.
template <int MT>
__device__ __forceinline__ void dw_tiles(const float* __restrict__ a_hi,
                                         const float* __restrict__ a_lo, int sa,
                                         const float* __restrict__ g_hi,
                                         const float* __restrict__ g_lo, int sg, int K, int N,
                                         float* dst, bool first, int share, int shares) {
  // the warps of the blocks that share this tile, as one row of warps
  const int warps = kConsumerWarps * shares;
  const int warp = share * kConsumerWarps + threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = (N + 7) / 8;
  const int m_blocks = (K + 15) / 16;
  // a 16-row block's tiles are cut into runs of whole groups of four, one
  // run a warp, as many as there are warps per block
  const int run_tiles =
      ((n_tiles + max(1, warps / m_blocks) - 1) / max(1, warps / m_blocks) + kWarpTiles - 1) /
      kWarpTiles * kWarpTiles;
  const int runs = (n_tiles + run_tiles - 1) / run_tiles;
  // pairs of neighbouring entries go as one 8-byte access where they are aligned
  const bool vec = N % 2 == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0;
  for (int u = warp; u < m_blocks * runs; u += warps) {
    const int m0 = u % m_blocks * 16;
    const int tile_begin = u / m_blocks * run_tiles;
    const int tile_end = min(n_tiles, tile_begin + run_tiles);
    // (columns of a past K, up to the block's 16, are the planes' zero pad)
    uint32_t ah[2 * MT][4], al[2 * MT][4];
#pragma unroll
    for (int s = 0; s < 2 * MT; ++s) {
      const int at = (4 * s + t) * 2 * sa + 2 * (m0 + g);
      const float2 h0 = *reinterpret_cast<const float2*>(a_hi + at);
      const float2 l0 = *reinterpret_cast<const float2*>(a_lo + at);
      const float2 h1 = *reinterpret_cast<const float2*>(a_hi + at + 16);
      const float2 l1 = *reinterpret_cast<const float2*>(a_lo + at + 16);
      ah[s][0] = __float_as_uint(h0.x), ah[s][2] = __float_as_uint(h0.y);
      ah[s][1] = __float_as_uint(h1.x), ah[s][3] = __float_as_uint(h1.y);
      al[s][0] = __float_as_uint(l0.x), al[s][2] = __float_as_uint(l0.y);
      al[s][1] = __float_as_uint(l1.x), al[s][3] = __float_as_uint(l1.y);
    }
    // the lane's B fragment of tile_begin, k-step 0 (k-step s: 8 s sg floats
    // on; the next tile: 16 floats on), and its entries of dW: rows m0 + g
    // and m0 + g + 8, columns 2 t, 2 t + 1 of each tile
    const float* bh = g_hi + t * 2 * sg + 2 * (tile_begin * 8 + g);
    const float* bl = g_lo + t * 2 * sg + 2 * (tile_begin * 8 + g);
    float* out = dst + (size_t)(m0 + g) * N + tile_begin * 8 + 2 * t;
    const bool row_live[2] = {m0 + g < K, m0 + g + 8 < K};
    for (int tile0 = tile_begin; tile0 < tile_end; tile0 += kWarpTiles) {
      // the sums so far start the accumulators: their loads from the
      // workspace fly while the fragments are read
      float acc[kWarpTiles][4];
      if (first) {
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        }
      } else {
        dw_load_sums(acc, out, K, N, vec, m0, tile0, tile_end, t, row_live);
      }
      // a group's tiles past the layer's last read the planes' pad and the
      // next row pair: their columns of the product are not stored
#pragma unroll
      for (int s = 0; s < 2 * MT; ++s) {
        uint32_t fh[kWarpTiles][2], fl[kWarpTiles][2];
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) {
          const float2 h = *reinterpret_cast<const float2*>(bh + s * 8 * sg + 16 * j);
          const float2 l = *reinterpret_cast<const float2*>(bl + s * 8 * sg + 16 * j);
          fh[j][0] = __float_as_uint(h.x), fh[j][1] = __float_as_uint(h.y);
          fl[j][0] = __float_as_uint(l.x), fl[j][1] = __float_as_uint(l.y);
        }
        // small terms first; consecutive products go to different accumulators
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) mma_tf32(acc[j], al[s], fh[j]);
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) mma_tf32(acc[j], ah[s], fl[j]);
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) mma_tf32(acc[j], ah[s], fh[j]);
      }
      if (dw_whole(vec, m0, tile0, tile_end, K, N)) {
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            *reinterpret_cast<float2*>(out + (size_t)8 * h * N + 8 * j) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = (tile0 + j) * 8 + 2 * t + e % 2;
            if (tile0 + j < tile_end && row_live[e / 2] && col < N) {
              out[(size_t)8 * (e / 2) * N + 8 * j + e % 2] = acc[j][e];
            }
          }
        }
      }
      bh += 16 * kWarpTiles;
      bl += 16 * kWarpTiles;
      out += 8 * kWarpTiles;
    }
  }
  if (share != 0) return;
  float* db = dst + (size_t)K * N;
  for (int c = threadIdx.x; c < N; c += kConsumers) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 16 * MT; ++r) {
      const int at = act_index(r, c, sg);
      s += g_hi[at] + g_lo[at];
    }
    db[c] = first ? s : db[c] + s;
  }
}

// Four consecutive weights W[row][n .. n + 3] of a (K, N) matrix from
// device memory, zeros past the matrix; one 16-byte load where `vec` (W
// 16-byte aligned, N a multiple of 4, and n one too).
__device__ __forceinline__ float4 load_w4(const float* __restrict__ W, int row, int n, int K,
                                          int N, bool vec) {
  if (row >= K || n >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = W + (size_t)row * N + n;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), n + 1 < N ? __ldg(p + 1) : 0.f, n + 2 < N ? __ldg(p + 2) : 0.f,
                     n + 3 < N ? __ldg(p + 3) : 0.f);
}

// One step of the dx chain for a warp that owns T 8-column tiles of the
// result from column `base` on, that is the weight rows base .. base +
// 8 T of W (K, N): out = g W^T. With dx the rows go to device memory
// unmasked (the first layer); else out * (a > 0) overwrites a's planes,
// columns past K as zeros. Accumulator j holds rows g, g + 8 and columns
// base + 8 j + 2 t, + 1: four neighbouring floats of a plane.
//
// The B fragment of W^T is W as it lies: B[k][n] = W[n][k], the lane's
// weight row base + 8 j + g. The contraction runs 16 columns of W at a
// time as two k-steps whose k index is dealt so that a lane's share is
// contiguous: the first k-step takes columns 4 t, 4 t + 1 of the 16, the
// second 4 t + 2, 4 t + 3. So a lane's four weights per tile are one
// 16-byte load from device memory (L2; every row's 64 bytes are used),
// fetched up to four rounds ahead of the products, and its A fragment of each
// k-step is one 16-byte load of g's planes, (g, c), (g + 8, c), (g,
// c + 1), (g + 8, c + 1). No weight of the chain passes through shared
// memory.
template <int MT, int T>
__device__ __forceinline__ void chain_tiles(const float* __restrict__ g_hi,
                                            const float* __restrict__ g_lo, int sg, float* a_hi,
                                            float* a_lo, int sa, const float* __restrict__ W,
                                            int K, int N, int base, float* __restrict__ dx,
                                            int row0, int rows) {
  // rounds of 16 columns whose weights are in registers at once: the fewer
  // tiles a warp has, the less work there is between a load and its use
  constexpr int D = MT * T == 1 ? 4 : MT * T == 2 ? 2 : 1;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const bool vec = aligned16(W) && N % 4 == 0;
  float acc[MT][T][4];
  float4 w[D][T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) w[d][j] = load_w4(W, base + 8 * j + g, 16 * d + 4 * t, K, N, vec);
  }
  const float* gh = g_hi + act_index(g, 4 * t, sg);
  const float* gl = g_lo + act_index(g, 4 * t, sg);
  for (int n0 = 0; n0 < N; n0 += 16 * D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int n = n0 + 16 * d;
      if (n >= N) break;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t ah[MT][4], al[MT][4], bh[T][2], bl[T][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float4 h = *reinterpret_cast<const float4*>(gh + i * 16 * sg + 2 * n + 4 * s);
          const float4 l = *reinterpret_cast<const float4*>(gl + i * 16 * sg + 2 * n + 4 * s);
          ah[i][0] = __float_as_uint(h.x), ah[i][1] = __float_as_uint(h.y);
          ah[i][2] = __float_as_uint(h.z), ah[i][3] = __float_as_uint(h.w);
          al[i][0] = __float_as_uint(l.x), al[i][1] = __float_as_uint(l.y);
          al[i][2] = __float_as_uint(l.z), al[i][3] = __float_as_uint(l.w);
        }
#pragma unroll
        for (int j = 0; j < T; ++j) {
          split_tf32(s == 0 ? w[d][j].x : w[d][j].z, bh[j][0], bl[j][0]);
          split_tf32(s == 0 ? w[d][j].y : w[d][j].w, bh[j][1], bl[j][1]);
        }
        // small terms first; consecutive products go to different accumulators
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
      // the round D rounds on takes this one's registers
#pragma unroll
      for (int j = 0; j < T; ++j) {
        w[d][j] = load_w4(W, base + 8 * j + g, n + 16 * D + 4 * t, K, N, vec);
      }
    }
  }
  if (dx != nullptr) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * i + g + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < T; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = base + 8 * j + 2 * t + e;
            if (c < K) dx[(size_t)r * K + c] = acc[i][j][2 * h + e];
          }
        }
      }
    }
    return;
  }
  consumer_sync();  // every warp is done with dW of this layer, which reads a
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int c = base + 8 * j + 2 * t;
      // (g, c), (g + 8, c), (g, c + 1), (g + 8, c + 1) of the 16-row block i
      const int at = act_index(16 * i + g, c, sa);
      const float4 m = *reinterpret_cast<const float4*>(a_hi + at);
      const float v[4] = {c < K && m.x > 0.f ? acc[i][j][0] : 0.f,
                          c < K && m.y > 0.f ? acc[i][j][2] : 0.f,
                          c + 1 < K && m.z > 0.f ? acc[i][j][1] : 0.f,
                          c + 1 < K && m.w > 0.f ? acc[i][j][3] : 0.f};
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t vh, vl;
        split_tf32(v[e], vh, vl);
        hi[e] = __uint_as_float(vh);
        lo[e] = __uint_as_float(vl);
      }
      *reinterpret_cast<float4*>(a_hi + at) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(a_lo + at) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  consumer_sync();
}

// The chain step of one layer, or of the `cols` columns of its result from
// c0 on (at most kChainCols), for the 16 consumer warps: the result's
// 8-column tiles are dealt to them in runs, as a layer's are in
// MLP_CONSUME_LAYER (a warp without tiles only joins the two barriers).
template <int MT>
__device__ __forceinline__ void chain_layer(const float* __restrict__ g_hi,
                                            const float* __restrict__ g_lo, int sg, float* a_hi,
                                            float* a_lo, int sa, const float* __restrict__ W,
                                            int K, int N, int c0, int cols,
                                            float* __restrict__ dx, int row0, int rows) {
  const int wn = threadIdx.x / kWarp;
  const int tiles = (cols + 7) / 8;
  const int tb = (tiles + kConsumerWarps - 1) / kConsumerWarps;
  const int base = c0 + wn * tb * 8;
  const int mine = max(0, min(tb, tiles - wn * tb));
#define CHAIN(T) \
  chain_tiles<MT, T>(g_hi, g_lo, sg, a_hi, a_lo, sa, W, K, N, base, dx, row0, rows)
  switch (mine) {
    case 0:
      if (dx == nullptr) {
        consumer_sync();
        consumer_sync();
      }
      break;
    case 1: CHAIN(1); break;
    case 2: CHAIN(2); break;
    case 3: CHAIN(3); break;
    default: CHAIN(kWarpTiles); break;
  }
#undef CHAIN
}

// `count` columns of the tile's rows from device memory (row length
// `width`; rows past `rows` and columns up to the next multiple of 8 as
// zeros), split into a hi and a lo plane.
__device__ __forceinline__ void load_rows(float* hi, float* lo, int stride, int tile_rows,
                                          const float* __restrict__ src, int width, int row0,
                                          int rows) {
  const int w8 = (width + 7) & ~7;
  for (int idx = threadIdx.x; idx < tile_rows * w8; idx += kConsumers) {
    const int r = idx / w8, c = idx - r * w8;
    const int gr = row0 + r;
    store_split(hi, lo, act_index(r, c, stride),
                gr < rows && c < width ? src[(size_t)gr * width + c] : 0.f);
  }
}

template <int MT>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_mlp_bwd_kernel(BwdArgs a, MlpArgs mlp, BwdPlan plan, int n_tiles) {
  constexpr int TM = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* planes = reinterpret_cast<float*>(smem + kBarrierBytes);
  Ring ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + kMaxStages;
  ring.buf = planes + plan.ring_at;
  ring.stage_floats = plan.stage_floats;
  ring.stages = plan.stages;
  if (threadIdx.x >= kConsumers) {
    producer_start(ring);
    bwd_produce(ring, mlp, plan, n_tiles, a.shares);
    return;
  }

  const int L = mlp.n_layers;
  // blocks slice * shares .. + shares - 1 walk the same tiles, each with its
  // share of dW; the first of them also writes db and dx
  const int slice = blockIdx.x / a.shares, share = blockIdx.x % a.shares;
  float* part = a.part + (size_t)slice * a.stride;
  RingPos pos;
#ifdef BWD_CLOCKS
  int n_stamps = 0;
#endif
  BWD_STAMP();
  // the planes' pad columns stay zero from here on: nothing writes them
  for (int i = threadIdx.x * 4; i < plan.ring_at; i += kConsumers * 4) {
    *reinterpret_cast<float4*>(planes + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  consumer_sync();
  for (int tile = slice; tile < n_tiles; tile += gridDim.x / a.shares) {
    const int row0 = tile * TM;
    const bool first = tile == slice;
    if (!first) consumer_sync();  // the last tile's readers of these planes are done
    load_rows(planes + plan.at[0], planes + plan.at[0] + TM * plan.sa[0], plan.sa[0], TM, a.x,
              mlp.dims[0], row0, a.rows);
    load_rows(planes + plan.at[L], planes + plan.at[L] + TM * plan.sa[L], plan.sa[L], TM, a.g,
              mlp.dims[L], row0, a.rows);
    if (first) {
      consumers_start();
    } else {
      consumer_sync();
    }
    BWD_STAMP();

    // forward recompute: a_{l+1} = relu(a_l W_l + b_l), l < L - 1
    for (int l = 0; l + 1 < L; ++l) {
      Tile tile;  // the layer's input planes
      tile.hi = planes + plan.at[l];
      tile.lo = tile.hi + TM * plan.sa[l];
      tile.extra = nullptr;
      tile.ring = ring;
      float* out = planes + plan.at[l + 1];
      const TileIo io{plan.sa[l], nullptr, row0, a.rows, nullptr, 0,
                      out, out + TM * plan.sa[l + 1], plan.sa[l + 1]};
      const int K = mlp.dims[l], N = mlp.dims[l + 1];
      const bool last = false;
      MLP_CONSUME_LAYER(MT, 1, false, true, false, plan.step[l], mlp.b[l]);
      BWD_STAMP();
    }

    // backward: layer l + 1's planes hold g_{l+1}, the cotangent of layer
    // l's output (l = L - 1: the planes of the kernel's input g)
    for (int l = L - 1; l >= 0; --l) {
      const int K = mlp.dims[l], N = mlp.dims[l + 1];
      float* a_hi = planes + plan.at[l];
      float* a_lo = a_hi + TM * plan.sa[l];
      const float* g_hi = planes + plan.at[l + 1];
      const float* g_lo = g_hi + TM * plan.sa[l + 1];
      dw_tiles<MT>(a_hi, a_lo, plan.sa[l], g_hi, g_lo, plan.sa[l + 1], K, N, part + a.offset[l],
               first, share, a.shares);
      BWD_STAMP();
      if (l == 0 && share != 0) break;  // dx is the slice's first block's
      chain_layer<MT>(g_hi, g_lo, plan.sa[l + 1], a_hi, a_lo, plan.sa[l], mlp.w[l], K, N, 0, K,
                      l == 0 ? a.dx : nullptr, row0, a.rows);
      BWD_STAMP();
    }
  }
}

// The wide path's kernel: fused_mlp_bwd_kernel's walk with the layers from
// a table, each recompute layer and chain step in passes of kChainCols
// columns, and the planes in the block's slot of the workspace unless the
// plan put them in shared memory.
template <int MT>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_mlp_bwd_wide_kernel(BwdArgs a, MlpTable mlp, WideBwdPlan plan, int n_tiles, float* slots) {
  constexpr int TM = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* f = reinterpret_cast<float*>(smem + kBarrierBytes);
  float* planes = opaque(plan.planes_smem ? f : slots + blockIdx.x * plan.slot_floats);
  const int L = mlp.n_layers;
  Ring ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + kMaxStages;
  ring.buf = f + (plan.planes_smem ? plan.plane_floats : 0);
  ring.stage_floats = plan.stage_floats;
  ring.stages = plan.stages;
  if (threadIdx.x >= kConsumers) {
    producer_start(ring);
    ProducerPos pp;
    for (int tile = blockIdx.x / a.shares; tile < n_tiles; tile += gridDim.x / a.shares) {
      for (int l = 0; l + 1 < L; ++l) {
        const LayerDesc d = mlp.layer[l];
        produce_layer_wide<false>(ring, pp, d, nullptr, d.K, kChainCols);
      }
    }
    return;
  }

  const int slice = blockIdx.x / a.shares, share = blockIdx.x % a.shares;
  float* part = a.part + (size_t)slice * a.stride;
  RingPos pos;
  // the planes' pad columns stay zero from here on: nothing writes them
  for (int i = threadIdx.x * 4; i < plan.plane_floats; i += kConsumers * 4) {
    *reinterpret_cast<float4*>(planes + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  consumer_sync();
  for (int tile = slice; tile < n_tiles; tile += gridDim.x / a.shares) {
    const int row0 = tile * TM;
    const bool first = tile == slice;
    if (!first) consumer_sync();  // the last tile's readers of these planes are done
    const LayerDesc in = mlp.layer[0], out = mlp.layer[L];
    load_rows(planes + in.at, planes + in.at + TM * in.sa, in.sa, TM, a.x, in.K, row0, a.rows);
    load_rows(planes + out.at, planes + out.at + TM * out.sa, out.sa, TM, a.g,
              mlp.layer[L - 1].N, row0, a.rows);
    if (first) {
      consumers_start();
    } else {
      consumer_sync();
    }

    // forward recompute: a_{l+1} = relu(a_l W_l + b_l), l < L - 1
    for (int l = 0; l + 1 < L; ++l) {
      const LayerDesc d = mlp.layer[l], e = mlp.layer[l + 1];
      Tile tile;  // the layer's input planes
      tile.hi = planes + d.at;
      tile.lo = tile.hi + TM * d.sa;
      tile.extra = nullptr;
      tile.ring = ring;
      float* o = planes + e.at;
      const TileIo io{d.sa, nullptr, row0, a.rows, nullptr, 0, o, o + TM * e.sa, e.sa};
      const int K = d.K, N = d.N, S = min(N, kChainCols);
      const bool last = false;
      for (int c0 = 0; c0 < N; c0 += kChainCols) {
        const int cols = min(kChainCols, N - c0);
        MLP_CONSUME_COLS(MT, 1, false, true, false, d.step, d.b, cols, S, c0, N);
      }
    }

    // backward: layer l + 1's planes hold g_{l+1}, the cotangent of layer
    // l's output (l = L - 1: the planes of the kernel's input g)
    for (int l = L - 1; l >= 0; --l) {
      const LayerDesc d = mlp.layer[l], e = mlp.layer[l + 1];
      float* a_hi = planes + d.at;
      float* a_lo = a_hi + TM * d.sa;
      const float* g_hi = planes + e.at;
      const float* g_lo = g_hi + TM * e.sa;
      dw_tiles<MT>(a_hi, a_lo, d.sa, g_hi, g_lo, e.sa, d.K, d.N, part + d.offset, first, share,
                   a.shares);
      if (l == 0 && share != 0) break;  // dx is the slice's first block's
      for (int c0 = 0; c0 < d.K; c0 += kChainCols) {
        chain_layer<MT>(g_hi, g_lo, e.sa, a_hi, a_lo, d.sa, d.w, d.K, d.N, c0,
                        min(kChainCols, d.K - c0), l == 0 ? a.dx : nullptr, row0, a.rows);
      }
    }
  }
}

// out[e] = sum over p < parts of part[p * stride + e], in the order of p.
__global__ void __launch_bounds__(kSumThreads)
sum_parts_kernel(const float* __restrict__ part, int parts, int stride, int total,
                 float* __restrict__ out) {
  for (int e = blockIdx.x * kSumThreads + threadIdx.x; e < total; e += gridDim.x * kSumThreads) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += part[(size_t)p * stride + e];
    out[e] = s;
  }
}

// Blocks and shares of a launch over tiles of 16 MT rows: at most one block
// per SM and as few slices as that takes: a slice is the sum of the tiles
// slice, slice + slices, ..., so the order of the sums depends on (rows, SM
// count) alone. Where the slices leave SMs idle (128 rows are 8 tiles), up
// to four blocks share a slice: each repeats the tile's recompute and chain
// and takes a share of its dW, the largest part of a tile's time.
template <int MT>
void grid(int rows, int sms, int* tiles, int* slices, int* shares) {
  *tiles = (rows + 16 * MT - 1) / (16 * MT);
  const int per_block = (*tiles + sms - 1) / sms;
  *slices = (*tiles + per_block - 1) / per_block;
  *shares = max(1, min(kMaxShares, sms / *slices));
}

// Launch the kernel over the stack in MlpArgs. Sets *slices; with one
// slice its blocks write grads.
template <int MT>
cudaError_t launch(BwdArgs a, const MlpArgs& mlp, const BwdPlan& plan, float* grads,
                   float* work, int work_parts, int device, int sms, cudaStream_t stream,
                   int* slices) {
  int tiles;
  grid<MT>(a.rows, sms, &tiles, slices, &a.shares);
  if (*slices > 1 && (work == nullptr || work_parts < *slices)) return cudaErrorInvalidValue;
  a.part = *slices > 1 ? work : grads;
  static bool done[kMaxDevices];
  cudaError_t e = allow_max_smem(fused_mlp_bwd_kernel<MT>, device, done);
  if (e != cudaSuccess) return e;
  fused_mlp_bwd_kernel<MT><<<*slices * a.shares, kBlockThreads, plan.smem, stream>>>(a, mlp, plan,
                                                                                    tiles);
  return cudaGetLastError();
}

// Launch the wide path, its layer table and the blocks' slots in `scratch`
// (wide_workspace). Sets *slices as launch does.
template <int MT>
int launch_wide(BwdArgs a, int n_layers, const int* dims, const float* const* weights,
                const float* const* biases, float* grads, float* work, int work_parts,
                void* scratch, size_t scratch_bytes, size_t* scratch_needed, int device, int sms,
                cudaStream_t stream, int* slices) {
  std::vector<LayerDesc> table = layer_table(n_layers, dims, weights, biases, 1);
  WideBwdPlan plan;
  plan_bwd_wide(table.data(), n_layers, 16 * MT, &plan);
  int tiles;
  grid<MT>(a.rows, sms, &tiles, slices, &a.shares);
  if (*slices > 1 && (work == nullptr || work_parts < *slices)) return -1;
  a.part = *slices > 1 ? work : grads;
  float* slots = nullptr;
  const int err = wide_workspace(table, (size_t)*slices * a.shares, plan.slot_floats, scratch,
                                 scratch_bytes, scratch_needed, stream, &slots);
  if (err != 0) return err;
  static bool done[kMaxDevices];
  const cudaError_t e = allow_max_smem(fused_mlp_bwd_wide_kernel<MT>, device, done);
  if (e != cudaSuccess) return (int)e;
  const MlpTable mlp{n_layers, static_cast<const LayerDesc*>(scratch), nullptr, dims[0]};
  fused_mlp_bwd_wide_kernel<MT><<<*slices * a.shares, kBlockThreads, plan.smem, stream>>>(
      a, mlp, plan, tiles, slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, dims[0]), g (rows, dims[n_layers]) -> dx (rows, dims[0]) and
// grads, one flat set dW_0 (dims[0], dims[1]), db_0 (dims[1]), dW_1, ...
// Weights[l] (dims[l], dims[l+1]) and biases[l] (dims[l+1]) as in the
// forward: any depth and widths of at least 1. `work` holds work_parts
// gradient sets, each padded to a multiple of 4 floats, one per slice of a
// launch over several tiles; there are at most as many slices as SMs, so
// work_parts = the device's SM count always suffices. A stack that takes
// the wide path needs a scratch workspace too: where scratch_bytes is less
// than it takes, nothing is launched and the call returns -2 with the
// bytes in *scratch_needed. All pointers are device pointers to contiguous
// f32. Returns 0 on a successful launch, a cudaError_t value if a launch
// failed, or -1 for arguments it refuses (no stack, a gradient set past
// 2^31 floats, or a workspace too small for the launch).
int fused_mlp_bwd(const float* x, const float* g, float* dx, float* grads, float* work,
                  int work_parts, int rows, int n_layers, const int* dims,
                  const float* const* weights, const float* const* biases, void* scratch,
                  size_t scratch_bytes, size_t* scratch_needed, void* stream) {
  if (rows < 0) return -1;
  const int stride = stack_width(n_layers, dims);
  if (stride < 0 || rows > INT_MAX / stride) return -1;
  BwdArgs a;
  a.x = x;
  a.g = g;
  a.dx = dx;
  a.part = nullptr;
  a.rows = rows;
  long long total = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (l < kInlineLayers) a.offset[l] = (int)total;
    total += (long long)dims[l] * dims[l + 1] + dims[l + 1];
  }
  if (total > INT_MAX - 3) return -1;
  a.total = (int)total;
  a.stride = (a.total + 3) & ~3;
  a.shares = 1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rows == 0) return (int)cudaMemsetAsync(grads, 0, total * sizeof(float), s);
  int device = 0, sms = 0, slices = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return (int)e;
  // 32-row tiles once 16-row tiles would take more than two waves of blocks
  // (on MlpArgs' path where the stack's planes fit twice: half the
  // read-add-writes of dW, and each weight fragment serves two row blocks),
  // else 16-row tiles; a stack whose 16-row planes do not fit, or deeper
  // than kInlineLayers, goes the wide path, at the tile height the same rule
  // picks
  const bool big = rows > 2 * sms * 16;
  int err = -1;
  bool inline_path = false;
  if (n_layers <= kInlineLayers) {
    MlpArgs mlp;
    fill_mlp_args(&mlp, n_layers, dims, weights, biases);
    BwdPlan plan;
    if (rows > 2 * sms * 16 && plan_bwd(mlp, 32, &plan)) {
      inline_path = true;
      e = launch<2>(a, mlp, plan, grads, work, work_parts, device, sms, s, &slices);
    } else if (plan_bwd(mlp, 16, &plan)) {
      inline_path = true;
      e = launch<1>(a, mlp, plan, grads, work, work_parts, device, sms, s, &slices);
    }
    if (inline_path) err = e == cudaErrorInvalidValue ? -1 : (int)e;
  }
  if (!inline_path) {
    err = big ? launch_wide<2>(a, n_layers, dims, weights, biases, grads, work, work_parts,
                               scratch, scratch_bytes, scratch_needed, device, sms, s, &slices)
              : launch_wide<1>(a, n_layers, dims, weights, biases, grads, work, work_parts,
                               scratch, scratch_bytes, scratch_needed, device, sms, s, &slices);
  }
  if (err != 0 || slices == 1) return err;
  sum_parts_kernel<<<(a.total + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      work, slices, a.stride, a.total, grads);
  return (int)cudaGetLastError();
}

#ifdef BWD_CLOCKS
// The stamps of the last launch into out (host memory, room for 256);
// returns their number, or a negative cudaError_t value.
int fused_mlp_bwd_clocks(long long* out) {
  int n = 0;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(&n, bwd_stamp_count, sizeof(n));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, bwd_stamps, sizeof(long long) * kMaxStamps);
  return e == cudaSuccess ? n : -(int)e;
}
#endif

}  // extern "C"
