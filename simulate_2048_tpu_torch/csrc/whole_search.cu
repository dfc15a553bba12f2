// Whole stochastic MuZero search, one CUDA kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel `ops/pallas_search.py`
// (`_make_kernel`, launched by `_run_packed`) in all four of its variants:
// value/Q/reward heads either (a) scalar (a column of `scal`) or (b)
// categorical (an (H, bins) block of `cat`, reduced in the kernel to its
// h-space expectation, `cat_expect` in the TPU kernel); weights packed by
// `pack_search_params` in (c) float32 or bfloat16; and the `hh` layers either
// resident (read from L2 where they are used) or (d) streamed through shared
// memory in call order (`stream_chunk`). It runs every simulation of B
// independent searches: traversal (PUCT at decision nodes, p/(1+N) at chance
// nodes, lockstep to the depth cap), expansion through both transitions
// (phi -> psi and g -> f: dense layers and pre-LayerNorm residual towers),
// and the backup of node and edge statistics. Root h/f, the prior softmax,
// noise and legality masking stay outside, in PyTorch, as they do around the
// TPU kernel.
//
// What bounds it on an H100: the dense H x H layers of the expansion. A
// simulation needs one transition, 2 (1 + 2 NB) + 2 layers (44 at NB=10,
// 5.8 MFLOP per search and simulation at H=256, 23 at H=512); this kernel
// computes both, as the TPU kernel does, so it does twice that work. In
// float32 without tensor cores that is the 67 TFLOP/s FP32 rate; a bfloat16
// pack does the same products that the tensor cores take at 989 TFLOP/s,
// which both bfloat16 libraries, resident and streamed, use (mma.sync).
// Behind the products' rate stands the weight traffic: each block reads the
// whole pack once per simulation (23 MB at H=256 in float32, 11.5 MB in
// bfloat16; 92 MB at H=512, 46 MB in bfloat16, more than or about the 50 MB
// L2). 100 dependent simulations leave no parallelism but the batch, so
// each block's chain of dependent layers sets the pace: the time of a launch
// hardly moves from 128 to 1,024 searches. The phase clocks below split that
// chain by phase in every library; PERF.md §5 holds their latest readings.
//
// Design. The TPU version keeps 128 searches' tree tables and all weights in
// VMEM and reads rows by one-hot mask sums (no gather on the TPU). Neither
// fits 227 KB of shared memory, so here:
// - one thread block owns G = 2 searches (the tensor-core libraries: 8) and
//   loops over all simulations. Each block streams the whole weight pack
//   from L2 once per simulation whatever G is, so small G buys blocks (SMs)
//   at the price of L2 traffic: at B=256 on an H100, G=2 (128 blocks)
//   measured fastest for the CUDA-core products, then 4, 8, 16; on the
//   tensor cores 4 and 8 are within 4% (PERF.md). Blocks never communicate;
// - tree tables live in global memory (allocated by the wrapper) and are
//   read and written with plain indexed loads and stores: one warp per
//   search in traversal (lane k = child slot k, warp reductions for the
//   min-max bounds and a first-index argmax), one thread per search in the
//   backup;
// - a float32 pack's activations are (H, G) float32 tiles in shared memory;
//   each dense layer is a hand-written FP32 product (FMAs) in which 2H
//   threads each own one output row and one half of the input range and
//   read the activations as broadcast float2s. The float32 resident
//   kernel (H <= 256, 2H + 32 threads) takes each layer through a ring of
//   three 64 KB shared-memory stages (T = 32 rows of each input half at
//   H=256), filled in call order by 1-D bulk copies (cp.async.bulk, no
//   tensor map) that one producer warp issues and that complete on
//   mbarriers; the ring runs on across layers and simulations, so the next
//   expansion's first tiles land during the heads, the backup and the
//   traversal. Its 2H computing threads synchronise on a named barrier,
//   each owns two adjacent outputs of one input half (float2 weights, float4
//   activations of two rows), and a stalled pipeline traps instead of
//   hanging. The streamed kernel (H <= 512, 1,024 threads) brings
//   each layer into shared memory in 64 KB tiles of rows (T rows of each
//   input half) with `cp.async`, double-buffered: the tile after the current
//   one, in the next layer when this one ends, is in flight while the block
//   computes, and the first tile of an expansion while it traverses, as the
//   TPU kernel's chunk DMAs are. Every output sums its rows in the same order
//   in both float32 kernels, so resident and streamed give bit-identical
//   searches;
// - both bfloat16 libraries run whole_search_mma_kernel (G = 8 searches a
//   block, kMmaWarps warps and a producer warp; any H % 32 == 0 up to
//   kMmaMaxH: resident 256, streamed 512), each with its own compile-time
//   shape (the constants below). It reads a copy of the pack's real hh
//   layers in call order (a resident pack's reordered, a streamed pack's as
//   they are) in mma.sync m16n8k16 A-fragment order (a lane's 8 weights in
//   16 bytes), through a ring of stages that one cp.async.bulk each fills
//   (MmaRing, Ring's protocol), across layers and simulations. Each warp
//   owns 16-output m-tiles; the tensor core sums each 16-input k-step, and
//   one float32 add a k-step takes that into the warp's accumulator,
//   k-steps in ascending order, whichever warp owns the m-tile. A tower's
//   layer norm is taken in the epilogue of the dense layer before it, by the
//   warps that own the values: each m-tile's sum and squared deviation per
//   column, combined in one order whichever warp owns the m-tile. So the two
//   libraries give bit-identical searches on one network. The activations are (columns, H + pad) tiles: float for the
//   residual stream, bfloat16 for the products, rounded once where the
//   epilogue writes them. Their searches agree with the plain version to the
//   noise of another order of sums (chip_smoke.py), not to the bit: no plain
//   version repeats the tensor core's sums;
// - a bfloat16 pack stores hh / win / wide / cat and the node embeddings in
//   bfloat16; every dense and head product rounds its input activation to
//   bfloat16 (`__float2bfloat16_rn`) and sums products of the widened values
//   in float32, as the TPU kernel's `x.astype(w.dtype)` and f32 accumulation
//   do. The scalar heads and every bias and LayerNorm vector stay float32;
// - a categorical head's logits are a (bins, G) tile in shared memory: the
//   block's threads split bins x input ranges, a second pass adds the partial
//   sums and the bias, and one warp per search takes the max, exponentials,
//   the two sums and one division (expf and a correctly rounded division,
//   as the plain version computes them);
// - LayerNorm uses eps 1e-6 and a variance as stable as the two-pass one
//   (float32 packs: the two-pass variance, the plain version's; tensor cores:
//   squared deviations about each m-tile's mean, combined by Chan's rule in
//   one order, which the plain version repeats with order="ksteps",
//   search_kernel.epilogue_layer_norm), argmax breaks ties at the first
//   index, and the arithmetic that selects edges (and, beside a bfloat16
//   pack, LayerNorm) uses correctly rounded intrinsics (no FMA contraction),
//   so that it matches the plain PyTorch version operation for operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

// Each library holds one variant (ops/_build.py builds the four in parallel):
// the weights' type, and resident or streamed hh. The float32 resident one
// (WHOLE_SEARCH_BF16=0, WHOLE_SEARCH_STREAMED=0) runs the ring.
#ifndef WHOLE_SEARCH_BF16
#define WHOLE_SEARCH_BF16 0
#endif
#ifndef WHOLE_SEARCH_STREAMED
#define WHOLE_SEARCH_STREAMED 0
#endif

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kUnvisited = -1;
constexpr unsigned kFull = 0xffffffffu;
using Weight = std::conditional_t<WHOLE_SEARCH_BF16, __nv_bfloat16, float>;
constexpr bool kStreamed = WHOLE_SEARCH_STREAMED;
// Both bfloat16 libraries run their dense layers on the tensor cores
// (mma.sync) over a fragment-ordered copy of the weights (MmaRing below).
constexpr bool kMma = WHOLE_SEARCH_BF16;
constexpr int kTileBytes = 64 * 1024;  // one streamed tile: T rows of both input halves
// The float32 resident library feeds its dense layers through a ring of
// weight tiles in shared memory (Ring below); the other three keep their feeds.
constexpr bool kRing = !WHOLE_SEARCH_BF16 && !WHOLE_SEARCH_STREAMED;
// The two libraries whose weight tiles a producer warp copies, beside the warps that compute.
constexpr bool kProducerWarp = kRing || kMma;
// The float32 ring's shape, each the fastest measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md): each block copies its own tiles (clusters of 2 blocks
// sharing each tile by multicast were no faster, since the blocks seldom wait
// on L2 for a tile; of 4, only 30 clusters fit the card at once); three 64 KB
// stages (six of 32 KB pay more per tile); two outputs a computing thread
// (dense_ring; one: more activation loads per weight; four: too few warps);
// rows taken 8 at a time (at 4, ptxas spilled inside the tile loop).
constexpr int kStages = 3;
constexpr int kRingStageBytes = 64 * 1024;
constexpr int kRingRows = 8;
constexpr int kBarrierFloats = 32;  // 2 kStages mbarriers of 8 bytes after the stages
static_assert(2 * kStages * 8 <= kBarrierFloats * 4, "the ring's barriers fit their slot");
constexpr unsigned kMaxSpins = 1u << 24;  // a wait that spins longer traps: the pipeline stalled

// The tensor-core libraries' shapes, each the fastest without a spill on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md). Both: G = 8 searches a block
// (the m16n8k16 product's 8 columns; 4: within the noise at 128-512, two
// waves at 1,024; 16: half again slower, measured streamed) and stages of
// 32 KB. Streamed (H <= 512): 12 consumer warps beside the producer (16 were
// 1.6% faster but spill under the 96 registers 17 warps leave; 8 and 15
// slower); 4 stages (3 stages, 2 of 64 KB, 8 of 16 KB slower). Resident
// (H <= 256): 8 consumer warps, two 16-output m-tiles each at H=256, 154
// registers (128 before the layer norms went into the epilogues; 16 warps, one m-tile each and 92 registers, were 2-5% slower
// at 256 and 1,024 searches; 12 within 1%, 1-2% slower at 1,024; with the
// layer norms in the epilogues, 16 and 12 at 256 searches 5% slower, 16
// spilling when clocked); 4 stages, one whole H=256 layer (5: within 1%,
// 33 KB more shared memory); its categorical heads split their sums as the
// streamed library's 12 warps do.
constexpr int kSearchesPerBlock = kMma ? 8 : 2;  // G
constexpr int kMmaMaxH = kStreamed ? 512 : 256;
constexpr int kStreamedMmaWarps = 12;
constexpr int kMmaWarps = kStreamed ? kStreamedMmaWarps : 8;
constexpr int kMmaStages = 4;
constexpr int kMmaStageBytes = 32 * 1024;
constexpr int kMmaMaxTiles = (kMmaMaxH / 16 + kMmaWarps - 1) / kMmaWarps;  // 16-row output tiles a warp
// The threads the resident library's categorical heads split their sums
// over: the streamed library's, so that the two sum every logit in one order.
constexpr int kHeadSplit = 32 * kStreamedMmaWarps;
constexpr int kActPad = 8;  // bfloat16 activations: (columns, H + kActPad), so that B fragments load without conflicts
constexpr int kRowPad = 4;  // float activations: (columns, H + kRowPad), so that the epilogues store without conflicts
static_assert(2 * kMmaStages * 8 <= kBarrierFloats * 4, "the tensor-core ring's barriers fit their slot");
static_assert(kSearchesPerBlock <= kMmaWarps, "traversal and layer norms take a warp per search");

struct Args {
  const float* root_h;  // (B, H)
  const float* root_p;  // (B, K) noised, masked, zero-padded priors
  const float* root_v;  // (B,) raw-space root values
  const void* hh;       // (n_hh, H, H) [layer][in][out], W; streamed: in call order
  const float* vecs;    // (n_vec, H) bias / LayerNorm vectors (the pack's (H, n_vec), transposed)
  const void* win;      // (2, K, H) action / chance input rows, W
  const void* wide;     // (2, H, K) policy / chance logit heads, W
  const float* wide_b;  // (K, 2)
  const float* scal;    // (H, 8) scalar heads: f value, psi q, g reward
  const float* scal_b;  // (1, 8)
  const void* cat;      // (H, CB) categorical heads: f value at 0, psi q at VB, g reward at 2 VB, W
  const float* cat_b;   // (CB, 1)
  float* visits;        // out (B, A)
  float* qvals;         // out (B, A)
  float* rootv;         // out (B,)
  void* emb;            // (B, N, H), W
  float* prior;         // (B, N, K)
  int* cidx;            // (B, N, K)
  float* cvis;          // (B, N, K)
  float* cval;          // (B, N, K)
  float* nvis;          // (B, N)
  float* nval;          // (B, N)
  float* nrew;          // (B, N)
  float* ndis;          // (B, N)
  float* ndec;          // (B, N) 1 = decision node
  int* path_nodes;      // (B, P)
  int* path_edges;      // (B, P)
  float* vbuf;          // (B, P + 1)
  int B, H, NB, S, K, A, P, n_vec;
  int CB, value_bins, reward_bins;  // bins == 1: that head is scalar
  float value_step, reward_step;    // support_max / (bins - 1): atom i = i * step
  float pb_c_init, pb_c_base, discount, temperature;
  int has_eps;
  float eps, four_eps, two_eps;
  int tile_rows;    // streamed: T, rows of each input half in one tile
  int tile_floats;  // streamed: the two tile buffers at the start of shared memory, in floats
};

struct Layout {
  size_t emb, prior, cidx, cvis, cval, nvis, nval, nrew, ndis, ndec, path_nodes, path_edges, vbuf, words;
};

Layout make_layout(size_t B, size_t H, size_t K, size_t S, size_t P, size_t emb_bytes) {
  const size_t N = S + 1;
  Layout L{};
  size_t off = 0;
  auto take = [&off](size_t words) {
    size_t at = off;
    off += (words + 63) / 64 * 64;  // 256-byte aligned tables
    return at;
  };
  L.emb = take((B * N * H * emb_bytes + 3) / 4);
  L.prior = take(B * N * K);
  L.cidx = take(B * N * K);
  L.cvis = take(B * N * K);
  L.cval = take(B * N * K);
  L.nvis = take(B * N);
  L.nval = take(B * N);
  L.nrew = take(B * N);
  L.ndis = take(B * N);
  L.ndec = take(B * N);
  L.path_nodes = take(B * P);
  L.path_edges = take(B * P);
  L.vbuf = take(B * (P + 1));
  L.words = off;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Largest value, first index among equals (jnp.argmax / torch.argmax).
__device__ __forceinline__ void warp_argmax(float& v, int& idx) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// Weights of type W (float or __nv_bfloat16) as float; a product's input
// activation as the weights' type rounds it (bfloat16: round to nearest even).
template <typename W>
__device__ __forceinline__ float to_f(W v) {
  if constexpr (sizeof(W) == 2) return __bfloat162float(v);
  else return v;
}
template <typename W>
__device__ __forceinline__ float load_w(const W* p) {
  if constexpr (sizeof(W) == 2) return __bfloat162float(*p);
  else return __ldg(p);
}
template <typename W>
__device__ __forceinline__ float act(float x) {
  if constexpr (sizeof(W) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}
template <typename W>
__device__ __forceinline__ W from_f(float x) {
  if constexpr (sizeof(W) == 2) return __float2bfloat16_rn(x);
  else return x;
}

// The streamed kernel's cursor over one expansion's weights: tile q holds
// rows [t T, t T + T) and [H/2 + t T, H/2 + t T + T) of call-order layer
// q / tpl (t = q % tpl), in buffer q % 2. Every thread keeps its own copy;
// all threads step it together.
struct Stream {
  float* buf;  // 2 buffers of (2, T, H): [half][row][out]
  int T;       // rows of each input half in a tile
  int tpl;     // tiles per layer: H / 2 / T
  int total;   // tiles of the real layers of one expansion
  int q;       // the next tile to compute

  // Every thread issues its share of tile q's 16-byte copies into buffer q % 2, as one group.
  __device__ void issue(const Args& a, int tile) const {
    const int H = a.H;
    const float* src = static_cast<const float*>(a.hh) + ((size_t)(tile / tpl) * H + (size_t)(tile % tpl) * T) * H;
    float* dst = buf + (size_t)(tile & 1) * 2 * T * H;
    const int pieces = T * H * (int)sizeof(float) / 16;  // per input half
    for (int e = threadIdx.x; e < 2 * pieces; e += blockDim.x) {
      const int half = e / pieces, piece = e % pieces;
      const char* from = reinterpret_cast<const char*>(src + (size_t)half * (H / 2) * H) + (size_t)piece * 16;
      char* to = reinterpret_cast<char*>(dst + (size_t)half * T * H) + (size_t)piece * 16;
      const unsigned shared = static_cast<unsigned>(__cvta_generic_to_shared(to));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared), "l"(from));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // Waits for this thread's copies (the block's need a __syncthreads after).
  __device__ void wait() const { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Waits for the phase of parity `parity` of the mbarrier at `bar` to
// complete; traps after kMaxSpins failed tries, so that a stalled pipeline
// ends the launch with an error (raised at the next synchronisation)
// instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == kMaxSpins) __trap();
  }
}

// Whether the phase of parity `parity` of the mbarrier at `bar` has completed, without waiting.
__device__ __forceinline__ bool mbar_done(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// The threads that compute: the whole block, but for a ring's producer warp.
__device__ __forceinline__ unsigned compute_threads() { return kProducerWarp ? blockDim.x - 32 : blockDim.x; }

// __syncthreads over the threads that compute (named barrier 1 beside the
// ring's producer warp, which never waits with them).
__device__ __forceinline__ void block_sync() {
  if constexpr (kProducerWarp) {
    asm volatile("bar.sync 1, %0;\n" ::"r"(compute_threads()) : "memory");
  } else {
    __syncthreads();
  }
}

// Phase clocks. Each kernel has a clocked instantiation, whose last argument
// is a Clock (ops/search_kernel.py launches it only while spans record), and
// an unclocked one, with no such argument. Helpers take the clock as a
// trailing pack `Clk&... clk`: empty in the unclocked kernels, so that every
// hook below compiles to nothing there. A lap adds the cycles since the last
// lap to the phase it names, so every cycle of a computing warp, from its
// start to its end, falls in exactly one phase:
// - kFeed: waiting for a weight stage that has not landed when the warp
//   comes to it (the rings' mbarrier waits; the float32 streamed library's
//   wait for its copies, and their issue);
// - kProducts: a dense layer from its start to its last FMA or mma.sync
//   k-step and the stage's release (the float32 ring: and the hand-off of
//   the second input half's partial sums);
// - kNorm: the rest of a dense layer (bias, row and residual adds, epilogue
//   stores), layer norms, scalar and categorical heads, logits, and the
//   priors' softmax;
// - kBarrier: waiting at a block-wide or named barrier of the computing
//   threads;
// - kTree: tree init, traversal, the parent embeddings' gather, the new
//   node's install, backup and root statistics.
// A thread keeps in registers its last lap, the cycles of the three phases
// that come many times a layer (kProducts, kNorm, kBarrier) and its dense
// layers; lane 0 adds them into its warp's row of a small shared array at the
// end of each simulation, and adds the rare phases (kFeed, kTree) there at
// once. The producer warp's lane 0 counts its stalls (waits for a free stage)
// as kFeed. At the block's end one atomic add per counter takes the block's
// totals into `out` (int64s, Counter order).
enum Phase { kFeed, kProducts, kNorm, kBarrier, kTree, kPhases };
// The counters (ops/search_kernel.py CLOCK_COUNTERS): the five phases, the
// computing warps' total cycles, the dense layers the block computed, the
// producer's cycles and stalls, and the layer norms the block took in the
// epilogue of a dense layer (the tensor-core kernel's tower layers).
enum Counter { kCycles = kPhases, kLayers, kProducerCycles, kProducerStalls, kEpilogueNorms, kCounters };
constexpr int kClockRows = 34;  // a row for each warp (at most 32 and a producer), and padding to 128 bytes
constexpr int kClockSlots = 8;  // a row: the phases, the warp's start (then its cycles), its dense layers, its norms
// A row keeps its epilogue layer norms in the slot of kProducerCycles, which no row holds (the producer's lane 0
// reads its cycles from its start).
constexpr int kNormSlot = kProducerCycles;

// Whether a lap reads %clock into a uniform register (S2UR) or the low half
// of %clock64 into two registers (CS2R, fewer cycles a lap): the kernels at
// their register limit (both float32 kernels, the streamed tensor-core one)
// have no register to spare and spill with CS2R reads, the resident
// tensor-core kernel has.
constexpr bool kUniformClock = !(kMma && !kStreamed);

__device__ __forceinline__ unsigned clock_lo() {
  if constexpr (kUniformClock) {
    unsigned t;
    asm volatile("mov.u32 %0, %%clock;" : "=r"(t)::"memory");
    return t;
  } else {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
    return (unsigned)t;
  }
}

// clock_lo after a barrier. A warp that reaches a bar.sync goes on issuing
// until an instruction needs the barrier, and a clock read does not: this
// one waits for the load of a shared word (`word`, never all ones), which
// waits for the barrier to release the warp: predicated on it (a register
// and a select) where registers allow, else behind a trap predicated on it.
__device__ __forceinline__ unsigned clock_after_barrier(const unsigned* word) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(word));
  unsigned now;
  if constexpr (kUniformClock) {
    asm volatile(
        "{\n .reg .pred p;\n .reg .u32 x;\n ld.volatile.shared.u32 x, [%1];\n"
        " setp.eq.u32 p, x, 0xffffffff;\n @p trap;\n mov.u32 %0, %%clock;\n}\n"
        : "=r"(now)
        : "r"(addr)
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n .reg .u32 x;\n ld.volatile.shared.u32 x, [%1];\n"
        " setp.ne.u32 p, x, 0xffffffff;\n @p mov.u32 %0, %%clock;\n @!p mov.u32 %0, 0;\n}\n"
        : "=r"(now)
        : "r"(addr)
        : "memory");
  }
  return now;
}

__device__ __forceinline__ unsigned long long clock_wide() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

struct Clock {
  unsigned long long* out;  // kCounters int64s, zeroed by the caller
  unsigned last;            // %clock at the last lap
  unsigned hot[3];          // kProducts, kNorm and kBarrier cycles since the last settle
  unsigned layers;          // dense layers since the last settle
  unsigned norms;           // layer norms taken in a dense layer's epilogue since the last settle

  // The warps' rows; their size, a multiple of 128 bytes, keeps the dynamic shared memory after them 128-byte
  // aligned.
  __device__ static unsigned long long* rows() {
    __shared__ __align__(128) unsigned long long counts[kClockRows * kClockSlots];
    return counts;
  }
  __device__ static unsigned long long* row() { return rows() + (threadIdx.x >> 5) * kClockSlots; }
  __device__ static bool first() { return (threadIdx.x & 31) == 0; }

  __device__ __forceinline__ void begin() {
    if (first()) {
      unsigned long long* r = row();
#pragma unroll
      for (int c = 0; c < kClockSlots; ++c) r[c] = 0;
      r[kCycles] = clock_wide();
    }
#pragma unroll
    for (int h = 0; h < 3; ++h) hot[h] = 0;
    layers = 0;
    norms = 0;
    last = clock_lo();
  }

  template <int P>
  __device__ __forceinline__ void add() {
    add<P>(clock_lo());
  }

  // The wait at a barrier just passed (a warp's layer count, read for it, is never all ones).
  __device__ __forceinline__ void add_barrier() {
    add<kBarrier>(clock_after_barrier(reinterpret_cast<const unsigned*>(row() + kLayers)));
  }

  // The cycles up to `now` belong to phase P.
  template <int P>
  __device__ __forceinline__ void add(unsigned now) {
    if constexpr (P == kProducts || P == kNorm || P == kBarrier) {
      hot[P - kProducts] += now - last;
    } else if (first()) {
      row()[P] += now - last;
    }
    last = now;
  }

  __device__ __forceinline__ void layer() { ++layers; }
  __device__ __forceinline__ void norm() { ++norms; }

  // Lane 0 adds the counts kept in registers to its warp's row (each simulation, so that no 32-bit count wraps).
  __device__ __forceinline__ void settle() {
    if (first()) {
      unsigned long long* r = row();
#pragma unroll
      for (int h = 0; h < 3; ++h) r[kProducts + h] += hot[h];
      r[kLayers] += layers;
      r[kNormSlot] += norms;
    }
#pragma unroll
    for (int h = 0; h < 3; ++h) hot[h] = 0;
    layers = 0;
    norms = 0;
  }

  // Every thread of the block calls it once, at its end: the producer warp
  // (which has left the computing threads' barrier) first.
  __device__ void flush() {
    settle();
    unsigned long long* r = row();
    if (kProducerWarp && threadIdx.x >= compute_threads()) {
      if (first()) {
        atomicAdd(out + kProducerCycles, clock_wide() - r[kCycles]);
        atomicAdd(out + kProducerStalls, r[kFeed]);
      }
      return;
    }
    if (first()) r[kCycles] = clock_wide() - r[kCycles];
    block_sync();
    const int c = threadIdx.x;
    if (c < kProducerCycles || c == kEpilogueNorms) {
      const bool every_warp = c == kLayers || c == kEpilogueNorms;  // counted alike by every warp: warp 0's
      const int warps = every_warp ? 1 : compute_threads() >> 5, slot = c == kEpilogueNorms ? kNormSlot : c;
      unsigned long long sum = 0;
      for (int w = 0; w < warps; ++w) sum += rows()[w * kClockSlots + slot];
      atomicAdd(out + c, sum);
    }
  }
};

// The cycles since the last lap belong to phase P.
template <int P, typename... Clk>
__device__ __forceinline__ void lap(Clk&... clk) {
  (clk.template add<P>(), ...);
}

// block_sync, the work before it ending in phase P and the wait counted as kBarrier.
template <int P, typename... Clk>
__device__ __forceinline__ void sync_lap(Clk&... clk) {
  lap<P>(clk...);
  block_sync();
  (clk.add_barrier(), ...);
}

// mbar_wait on a ring's barrier. A clocked warp probes first and, only if it
// must wait, counts the wait as kFeed and the work before it as kProducts:
// its products run on from tile to tile without a lap while the ring keeps up.
// The producer warp waits here for a free stage: its kFeed is its stalls.
template <typename... Clk>
__device__ __forceinline__ void feed_wait(unsigned bar, unsigned parity, Clk&... clk) {
  if constexpr (sizeof...(Clk) > 0) {
    if (mbar_done(bar, parity)) return;
    lap<kProducts>(clk...);
    mbar_wait(bar, parity);
    lap<kFeed>(clk...);
  } else {
    mbar_wait(bar, parity);
  }
}

// The warps that compute the ring kernel's dense layers: H threads of two
// outputs each, whole warps since H is a multiple of 32.
__device__ __forceinline__ int dense_warps(int H) { return H / 32; }

// The ring kernel's slot for the LayerNorm vectors (gamma, beta: 2H floats)
// that the next layer norm takes, at the end of the ring's region.
__device__ __forceinline__ float* ln_vectors(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  return smem + a.tile_floats - 2 * a.H;
}

// The float32 resident kernel's ring of weight tiles. Tile q of the launch
// (q < S x n_real x tpl: every simulation's expansion, its layers in call
// order) holds rows [t T, t T + T) and [H/2 + t T, H/2 + t T + T) of
// call-order layer (q / tpl) % n_real (t = q % tpl), pack layer
// (that + rot) % n_real, in stage q % kStages: two 1-D bulk copies
// (cp.async.bulk) land it and complete their bytes on the stage's full
// mbarrier. A producer warp beside the 2H threads that compute does nothing
// else (CUTLASS's PipelineTmaAsync, without its classes): its lane 0 waits
// until every computing warp has released stage s, arms the stage's full
// barrier for its next tile and issues the copies. A computing warp waits on
// the full barrier of tile q, reads it, and releases the stage with one
// arrive (lane 0) on its empty barrier, which counts every computing warp.
// The phases come from q alone: stage q % kStages fills for the
// (q / kStages)-th time. Every thread keeps its own copy of the cursor. A
// launch without clusters runs each block as a cluster of one, so the
// copies' shared::cluster addresses and the .cluster fence are this block's.
struct Ring {
  float* buf;          // kStages stages of (2, T, H): [half][row][out]
  unsigned bars;       // shared address of full[0]; full[s] at + 8 s, empty[s] at + 8 (kStages + s)
  int H, T, tpl;       // tpl: tiles per layer, H / 2 / T
  int n_real;          // layers of one expansion
  int rot;             // pack layer of call-order layer j: (j + rot) % n_real
  int total;           // tiles of the launch
  int q;               // the next tile to compute

  __device__ unsigned full(int s) const { return bars + 8 * s; }
  __device__ unsigned empty(int s) const { return bars + 8 * (kStages + s); }
  __device__ unsigned tile_bytes() const { return (unsigned)(2 * T * H) * sizeof(float); }

  // Sets up the cursor and initialises the barriers. Every thread of the
  // block, the producer warp's too, calls it.
  __device__ void start(const Args& a, float* smem, int tower_hh) {
    H = a.H;
    T = a.tile_rows;
    tpl = H / 2 / T;
    n_real = 4 * tower_hh + 4;
    rot = tower_hh;
    total = a.S * n_real * tpl;
    q = 0;
    buf = smem;
    bars = smem_addr(smem + (size_t)kStages * 2 * T * H);
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full(s)) : "memory");
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(empty(s)), "r"(dense_warps(H)) : "memory");
      }
      // The initialisation is visible to the copies' completions (CUTLASS's fence_barrier_init).
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers are initialised before any arrive or copy reaches them
  }

  // This block's full barrier of stage s expects one tile's bytes.
  __device__ void arm(int s) const {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(full(s)), "r"(tile_bytes())
                 : "memory");
  }

  // Tile r into stage r % kStages.
  __device__ void issue(const Args& a, int r) const {
    const int j = (r / tpl) % n_real, t = r % tpl;
    const int layer = j + rot < n_real ? j + rot : j + rot - n_real;
    const float* src = static_cast<const float*>(a.hh) + ((size_t)layer * H + (size_t)t * T) * H;
    const int s = r % kStages;
    const unsigned dst = smem_addr(buf + (size_t)s * 2 * T * H);
    const unsigned bytes = tile_bytes() / 2;  // one input half
    for (int half = 0; half < 2; ++half) {
      const float* from = src + (size_t)half * (H / 2) * H;
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                       dst + half * bytes),
                   "l"(from), "r"(bytes), "r"(full(s))
                   : "memory");
    }
  }

  // The producer warp's lane 0: every tile of the launch, in order.
  template <typename... Clk>
  __device__ void produce(const Args& a, Clk&... clk) const {
    for (int r = 0; r < total; ++r) {
      const int s = r % kStages, k = r / kStages;
      if (k > 0) feed_wait(empty(s), (k - 1) & 1, clk...);  // the block is done with tile r - kStages
      arm(s);
      issue(a, r);
      if ((r & 63) == 63) (clk.settle(), ...);  // a clock's 32-bit counts, settled before they can wrap
    }
  }

  // A computing thread: waits for tile q and returns its stage.
  template <typename... Clk>
  __device__ const float* ready(Clk&... clk) const {
    const int s = q % kStages;
    feed_wait(full(s), (q / kStages) & 1, clk...);
    return buf + (size_t)s * 2 * T * H;
  }

  // A computing warp is done with tile q: its lane 0 releases the stage to the producer.
  __device__ void release() const {
    __syncwarp();
    if ((threadIdx.x & 31) != 0) return;
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(empty(q % kStages)) : "memory");
  }
};

// The tensor-core ring's tile: the most k-steps (16 input rows each, a
// divisor of H / 16) whose fragments, (H / 16) m-tiles of 512 bytes each,
// fit kMmaStageBytes.
__host__ __device__ inline int mma_tile_ksteps(int H) {
  const int n = H / 16;
  int kt = 1;
  for (int d = 1; d <= n; ++d) {
    if (n % d == 0 && d * n * 512 <= kMmaStageBytes) kt = d;
  }
  return kt;
}

// Floats of shared memory the tensor-core ring takes: its stages, then its barriers.
__host__ __device__ inline int mma_ring_floats(int H) {
  return kMmaStages * mma_tile_ksteps(H) * (H / 16) * 512 / 4 + kBarrierFloats;
}

// The tensor-core libraries' ring of weight tiles. Its weights are a copy of
// the pack's real hh layers, in call order, in mma.sync fragment order
// (ops/search_kernel.py mma_fragments): layer, k-step (16 input rows),
// m-tile (16 outputs), lane, and the lane's eight bfloat16 A values (its
// four registers of m16n8k16) in 16 bytes. A tile is kt consecutive
// k-steps of one layer for all its m-tiles: one contiguous run of bytes,
// which one cp.async.bulk copies. Tile r of a launch is tile
// (first + r) % period of the copy. The protocol is Ring's: the producer
// warp's lane 0 waits until every reading warp has released stage s, arms
// the stage's full barrier and issues the copy; a reading warp waits on the
// full barrier, reads its fragments and releases the stage with one arrive
// (lane 0). The phases come from the tile index alone.
struct MmaRing {
  const char* src;      // the fragment copy
  char* buf;            // kMmaStages stages of tile_bytes
  unsigned bars;        // full[s] at + 8 s, empty[s] at + 8 (kMmaStages + s)
  unsigned tile_bytes;  // kt k-steps of H / 16 m-tiles of 512 bytes
  int kt, tpl;          // k-steps a tile, tiles a layer
  int first, period, total;
  int q;                // the next tile to compute

  __device__ unsigned full(int s) const { return bars + 8 * s; }
  __device__ unsigned empty(int s) const { return bars + 8 * (kMmaStages + s); }

  // Layer calls `calls` of the copy's layers first_layer, first_layer + 1, ...
  // (modulo period_layers), read by `readers` warps. Every thread of the
  // block, the producer warp's too, calls it.
  __device__ void start(const void* frag, void* smem, int H, int first_layer, int period_layers, int calls,
                        int readers) {
    kt = mma_tile_ksteps(H);
    tpl = H / 16 / kt;
    tile_bytes = (unsigned)(kt * (H / 16) * 512);
    src = static_cast<const char*>(frag);
    buf = static_cast<char*>(smem);
    bars = smem_addr(buf + (size_t)kMmaStages * tile_bytes);
    first = first_layer * tpl;
    period = period_layers * tpl;
    total = calls * tpl;
    q = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kMmaStages; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full(s)) : "memory");
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(empty(s)), "r"(readers) : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // The producer warp's lane 0: every tile of the launch, in order.
  template <typename... Clk>
  __device__ void produce(Clk&... clk) const {
    for (int r = 0; r < total; ++r) {
      const int s = r % kMmaStages, k = r / kMmaStages;
      if (k > 0) feed_wait(empty(s), (k - 1) & 1, clk...);  // every reader is done with tile r - kMmaStages
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(full(s)), "r"(tile_bytes)
                   : "memory");
      const char* from = src + (size_t)((first + r) % period) * tile_bytes;
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                       smem_addr(buf + (size_t)s * tile_bytes)),
                   "l"(from), "r"(tile_bytes), "r"(full(s))
                   : "memory");
      if ((r & 63) == 63) (clk.settle(), ...);
    }
  }

  // A reading warp: waits for tile q and returns its fragments.
  template <typename... Clk>
  __device__ const uint4* ready(Clk&... clk) const {
    const int s = q % kMmaStages;
    feed_wait(full(s), (q / kMmaStages) & 1, clk...);
    return reinterpret_cast<const uint4*>(buf + (size_t)s * tile_bytes);
  }

  // A reading warp is done with tile q: its lane 0 releases the stage.
  __device__ void release() const {
    __syncwarp();
    if ((threadIdx.x & 31) != 0) return;
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(empty(q % kMmaStages)) : "memory");
  }
};

// acc (16 x 8, float32) += a (16 x 16, bfloat16, a lane's fragment) b (16 x 8, bfloat16, two registers): the
// tensor core sums the k-step's 16 products into a zero accumulator, and one rounded float32 add per value takes
// that into acc (the k-step order of the plain version, bf16_dense_sum's "ksteps").
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint4& a, unsigned b0, unsigned b1) {
  float d[4];
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// acc[g] += w * x[g] over one input row (x: G activations, read as float2s).
template <int G>
__device__ __forceinline__ void fma_row(float (&acc)[G], float w, const float* x) {
  const float2* x2 = reinterpret_cast<const float2*>(x);
#pragma unroll
  for (int q = 0; q < G / 2; ++q) {
    const float2 xv = x2[q];
    acc[2 * q + 0] = fmaf(w, xv.x, acc[2 * q + 0]);
    acc[2 * q + 1] = fmaf(w, xv.y, acc[2 * q + 1]);
  }
}

// How a thread of the float32 streamed kernel sums the products of its input
// half, 8 rows at a time: one FMA chain, row after row.
template <int G>
struct RowSum {
  float acc[G];

  __device__ __forceinline__ RowSum() {
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
  }

  // Rows u = 0..7: weight w[u], activations x + u * G.
  __device__ __forceinline__ void add8(const float (&w)[8], const float* x) {
#pragma unroll
    for (int u = 0; u < 8; ++u) fma_row<G>(acc, w[u], x + u * G);
  }
};

// h^-1 (ops/value_transform.py), operation for operation.
__device__ __forceinline__ float untransform(const Args& a, float x) {
  if (!a.has_eps) return x;
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float inside = __fadd_rn(1.f, __fmul_rn(a.four_eps, __fadd_rn(__fadd_rn(fabsf(x), 1.f), a.eps)));
  const float t = __fdiv_rn(__fsub_rn(__fsqrt_rn(inside), 1.f), a.two_eps);
  return __fmul_rn(sign, __fsub_rn(__fmul_rn(t, t), 1.f));
}

// One warp picks the edge to follow from `node` of search `b`; every lane
// returns the edge and the child index stored there.
__device__ void pick(const Args& a, int b, int node, int lane, int& edge, int& next) {
  const size_t nrow = (size_t)b * (a.S + 1) + node;
  const size_t row = nrow * a.K;
  float pr = 0.f, vis = 0.f, q = 0.f;
  int ci = kUnvisited;
  if (lane < a.K) {
    pr = a.prior[row + lane];
    vis = a.cvis[row + lane];
    q = a.cval[row + lane];
    ci = a.cidx[row + lane];
  }
  const float pv = a.nval[nrow];
  const float pn = a.nvis[nrow];
  const bool dec = a.ndec[nrow] > 0.f;

  const float completed = (lane < a.K && vis > 0.f) ? q : pv;
  const float lo = fminf(warp_min(completed), pv);
  const float hi = fmaxf(warp_max(completed), pv);
  const float qt = __fdiv_rn(__fsub_rn(completed, lo), fmaxf(__fsub_rn(hi, lo), 1e-8f));
  const float pb_c = __fadd_rn(a.pb_c_init, logf(__fdiv_rn(__fadd_rn(__fadd_rn(pn, a.pb_c_base), 1.f), a.pb_c_base)));
  const float one_vis = __fadd_rn(1.f, vis);
  const float explore = __fdiv_rn(__fmul_rn(__fmul_rn(pb_c, pr), __fsqrt_rn(fmaxf(pn, 1.f))), one_vis);
  const float puct = __fadd_rn(qt, explore);
  const float chance = __fdiv_rn(pr, one_vis);
  float score = dec ? puct : chance;
  if (!(pr > 0.f)) score = kNegInf;
  if (lane >= a.K) score = -INFINITY;
  int idx = lane;
  warp_argmax(score, idx);
  edge = idx;
  next = __shfl_sync(kFull, ci, idx);
}

// Float32 loads of U consecutive floats (U = 2, 4), 4 U-byte aligned.
template <int U>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[U]) {
  static_assert(U == 2 || U == 4, "float2 or float4 loads");
  if constexpr (U == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  }
}

// The float32 resident kernel's dense layer (dense's contract), on the tiles
// of its Ring: H threads, thread t owning outputs o0 and o0 + 1 of input
// half `half`; each output sums its half's rows in order, one FMA
// chain per search, as RowSum<G> does, so every output's bits are
// those of one thread per output. A warp reads a row's weights as one
// float2 load per lane and the activations of 2 rows as one broadcast
// float4 (G = 2), kRingRows rows at a time. The epilogue's global loads, and
// the next layer norm's vectors (ln_next: vectors iv + 1, iv + 2, which
// half 1 parks in shared memory for it), are issued before the tiles.
template <int G, typename... Clk>
__device__ void dense_ring(const Args& a, Ring& st, int iv, const float* in, float* out, float* part,
                           const float* rows, const int* row_idx, bool residual, bool ln_next, Clk&... clk) {
  constexpr int U = 2;  // outputs a thread
  static_assert(G == 2, "activations are read as float4s of two rows");
  const int H = a.H;
  const int per_half = H / U;
  const bool active = (int)threadIdx.x < 2 * per_half;  // whole warps
  const int half = threadIdx.x / per_half;
  const int o0 = (threadIdx.x % per_half) * U;
  const int i0 = half * (H / 2);
  float acc[U][G], bias[U], row[U][G], gamma[U], beta[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
#pragma unroll
    for (int g = 0; g < G; ++g) acc[k][g] = 0.f;
  }
  if (active && half == 0) {
    load_vec<U>(a.vecs + (size_t)iv * H + o0, bias);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float r[U] = {};
      if (rows != nullptr) load_vec<U>(rows + (size_t)row_idx[g] * H + o0, r);
#pragma unroll
      for (int k = 0; k < U; ++k) row[k][g] = r[k];
    }
  } else if (active && ln_next) {
    load_vec<U>(a.vecs + (size_t)(iv + 1) * H + o0, gamma);
    load_vec<U>(a.vecs + (size_t)(iv + 2) * H + o0, beta);
  }
  (clk.layer(), ...);
  for (int t = 0; t < st.tpl; ++t, ++st.q) {
    if (!active) continue;
    const float* w = st.ready(clk...) + (size_t)half * st.T * H + o0;
    const float* x = in + (i0 + t * st.T) * G;
    constexpr int R = kRingRows;
    for (int u = 0; u < st.T; u += R) {
      float wr[R][U], xq[R * G / 4][4];
#pragma unroll
      for (int v = 0; v < R; ++v) load_vec<U>(w + (size_t)(u + v) * H, wr[v]);
#pragma unroll
      for (int v = 0; v < R * G / 4; ++v) load_vec<4>(x + (u + 2 * v) * G, xq[v]);
#pragma unroll
      for (int v = 0; v < R; ++v) {
#pragma unroll
        for (int k = 0; k < U; ++k) {
#pragma unroll
          for (int g = 0; g < G; ++g) acc[k][g] = fmaf(wr[v][k], xq[(v * G + g) / 4][(v * G + g) % 4], acc[k][g]);
        }
      }
    }
    st.release();
  }
  if (active && half == 1) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
#pragma unroll
      for (int g = 0; g < G; ++g) part[(o0 + k) * G + g] = acc[k][g];
      if (ln_next) {
        ln_vectors(a)[o0 + k] = gamma[k];
        ln_vectors(a)[H + o0 + k] = beta[k];
      }
    }
  }
  sync_lap<kProducts>(clk...);
  if (active && half == 0) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int o = o0 + k;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v = (acc[k][g] + part[o * G + g]) + bias[k];
        if (rows != nullptr) v += row[k][g];
        if (residual) v += out[o * G + g];
        out[o * G + g] = v;
      }
    }
  }
  sync_lap<kNorm>(clk...);
}

// out (H, G) = W^T in + vec[iv] (+ rows[row_idx[g]] | + out) for the next
// layer W of a float32 pack: `st` (the streamed kernel's Stream, the
// resident one's Ring) stands at its first tile. The streamed kernel's 2H
// threads: thread t owns output row t % H and input half t / H, and sums its
// half's products as RowSum does; the ring's, dense_ring.
template <int G, typename Feed, typename... Clk>
__device__ void dense(const Args& a, Feed& st, int iv, const float* in, float* out, float* part, const float* rows,
                      const int* row_idx, bool residual, Clk&... clk) {
  if constexpr (kRing) {
    dense_ring<G>(a, st, iv, in, out, part, rows, row_idx, residual, false, clk...);
  } else {
    const int H = a.H;
    const int o = threadIdx.x % H;
    const int half = threadIdx.x / H;
    const int i0 = half * (H / 2);
    static_assert(G % 2 == 0, "activations are read as float2s");
    RowSum<G> sum;
    (clk.layer(), ...);
    for (int t = 0; t < st.tpl; ++t) {
      st.wait();  // this thread's copies of tile st.q
      lap<kFeed>(clk...);
      __syncthreads();  // everyone's; and the other buffer's last readers are done
      (clk.add_barrier(), ...);
      if (st.q + 1 < st.total) st.issue(a, st.q + 1);
      lap<kFeed>(clk...);
      const float* w = st.buf + (size_t)(st.q & 1) * 2 * st.T * H + (size_t)half * st.T * H + o;
      const float* x = in + (i0 + t * st.T) * G;
      for (int u = 0; u < st.T; u += 8) {
        float wr[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) wr[v] = w[(size_t)(u + v) * H];
        sum.add8(wr, x + u * G);
      }
      ++st.q;
      lap<kProducts>(clk...);
    }
    if (half == 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) part[o * G + g] = sum.acc[g];
    }
    sync_lap<kNorm>(clk...);
    if (half == 0) {
      const float bias = a.vecs[(size_t)iv * H + o];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v = (sum.acc[g] + part[o * G + g]) + bias;
        if (rows != nullptr) v += rows[(size_t)row_idx[g] * H + o];
        if (residual) v += out[o * G + g];
        out[o * G + g] = v;
      }
    }
    sync_lap<kNorm>(clk...);
  }
}

// A balanced tree over v[0..N-1], N a power of two: halving, as the plain
// version sums a lane's values.
template <int N>
__device__ __forceinline__ float tree(float (&v)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int j = 0; j < N; j += 2 * w) v[j] = __fadd_rn(v[j], v[j + w]);
  }
  return v[0];
}

// out = relu(LayerNorm(in) * vec[iv] + vec[iv + 1]) of a float32 pack, one
// warp per column; `out` may alias `in`.
template <int G, typename... Clk>
__device__ void layer_norm_relu(const Args& a, int iv, const float* in, float* out, Clk&... clk) {
  const int H = a.H;
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += compute_threads() >> 5) {
    if constexpr (kRing) {
      // The float32 branch below, with this lane's values in registers (H <= 256) and the vectors from the
      // slot where the dense layer before this one parked them.
      const float* vec = ln_vectors(a);
      float v[8], gamma[8], beta[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = lane + 32 * j;
        gamma[j] = i < H ? vec[i] : 0.f;
        beta[j] = i < H ? vec[H + i] : 0.f;
        v[j] = i < H ? in[i * G + g] : 0.f;
      }
      const float inv_h = 1.f / (float)H;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (lane + 32 * j < H) s += v[j];
      }
      const float mean = warp_sum(s) * inv_h;
      float s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = v[j] - mean;
        if (lane + 32 * j < H) s2 += v[j] * v[j];
      }
      const float r = rsqrtf(warp_sum(s2) * inv_h + 1e-6f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float y = v[j] * r;
        const float z = y * gamma[j] + beta[j];
        if (lane + 32 * j < H) out[(lane + 32 * j) * G + g] = fmaxf(z, 0.f);
      }
    } else {
      const float inv_h = 1.f / (float)H;
      float s = 0.f;
      for (int i = lane; i < H; i += 32) s += in[i * G + g];
      const float mean = warp_sum(s) * inv_h;
      float s2 = 0.f;
      for (int i = lane; i < H; i += 32) {
        const float d = in[i * G + g] - mean;
        s2 += d * d;
      }
      const float r = rsqrtf(warp_sum(s2) * inv_h + 1e-6f);
      for (int i = lane; i < H; i += 32) {
        const float y = (in[i * G + g] - mean) * r;
        const float z = y * a.vecs[(size_t)iv * H + i] + a.vecs[(size_t)(iv + 1) * H + i];
        out[i * G + g] = fmaxf(z, 0.f);
      }
    }
  }
  sync_lap<kNorm>(clk...);
}

// A dense layer of a tower, which a layer norm follows: the ring kernel's
// brings that layer norm's vectors along.
template <int G, typename Feed, typename... Clk>
__device__ __forceinline__ void tower_dense(const Args& a, Feed& st, int iv, const float* in, float* out, float* part,
                                            bool residual, Clk&... clk) {
  if constexpr (kRing) {
    dense_ring<G>(a, st, iv, in, out, part, nullptr, nullptr, residual, true, clk...);
  } else {
    dense<G>(a, st, iv, in, out, part, nullptr, nullptr, residual, clk...);
  }
}

// TowerWithHead: dense -> NB pre-LN residual blocks -> LN -> relu; result in x.
// `in` may alias u (it is consumed by the first layer).
template <int G, typename Feed, typename... Clk>
__device__ void tower(const Args& a, Feed& st, int iv, const float* in, float* x, float* t, float* u, float* part,
                      Clk&... clk) {
  tower_dense<G>(a, st, iv, in, x, part, false, clk...);
  iv += 1;
  for (int blk = 0; blk < a.NB; ++blk) {
    layer_norm_relu<G>(a, iv, x, t, clk...);
    tower_dense<G>(a, st, iv + 2, t, u, part, false, clk...);
    layer_norm_relu<G>(a, iv + 3, u, u, clk...);
    tower_dense<G>(a, st, iv + 5, u, x, part, true, clk...);
    iv += 6;
  }
  layer_norm_relu<G>(a, iv, x, x, clk...);
}

// The layer norm that a tower's dense layer takes into its epilogue (dense_mma's `ln`): relu(LayerNorm(v) *
// vec[iv] + vec[iv + 1]) of each column v of the layer's output, eps 1e-6.
struct EpilogueNorm {
  int iv;
  float inv_h;         // 1 / H, rounded
  float* stats;        // (H / 16, G) float2s: an m-tile's sum and squared deviation about its mean, per column
  __nv_bfloat16* xb;   // the result's bfloat16 rounding (columns, H + kActPad), the next dense layer's input
  float* heads;        // unless null, the float result (H, G), the heads' layout
};

// The tensor-core libraries' dense layer: v = W[layer]^T x + vec[iv] (+ rows[row_idx[g]]) (+ residual), x being
// the bfloat16 activations `xin` (columns, H + kActPad), on the tiles of `st`, which must stand at this layer's
// first tile. Reading warp w owns the 16-output m-tiles w, w + kMmaWarps, ...: for each k-step of a tile it loads
// the k-step's B fragments (two 4-byte loads a lane for each 8 columns) and, for each of its m-tiles, the A
// fragment (one 16-byte load a lane, conflict-free) into mma.sync m16n8k16, accumulating in float32 registers in
// ascending k-steps (mma_bf16). The epilogue adds in dense's order: the bias, then the input row, then the
// residual (columns, H + kRowPad). It writes, each unless null, v as float to `out` (columns, H + kRowPad) and its
// bfloat16 rounding to `xout` (columns, H + kActPad), the next product's input (the TPU kernel's
// x.astype(w.dtype), done once here instead of at every product).
//
// Given an EpilogueNorm (`ln`; nullptr: none) it takes the layer norm after the layer instead of writing `xout`,
// with gamma and beta loaded beside the bias, before the products; `out` then takes v. Each warp re-reads its own
// m-tiles from `out` (8 rows of a column a lane, added as a balanced tree, the other 8 by the next lane) into
// each m-tile's sum and squared deviation about its mean, per column, in ln.stats. After the barrier four lanes
// combine each column, whichever warp owns its m-tiles, so the two libraries normalise alike: Chan's rule for
// groups, the mean of the sums, then each m-tile's squared deviation plus 16 times its mean's squared distance
// from the mean; and each warp normalises its own values, still in registers. Every operation of the norm is
// rounded on its own (no FMA contraction) and 1 / sqrt correctly rounded, as search_kernel.epilogue_layer_norm
// repeats. A layer without a norm must not write the bfloat16 tile it reads; with one, it writes ln.xb after the
// barrier.
template <int G, typename Ln, typename... Clk>
__device__ void dense_mma(const Args& a, MmaRing& st, int iv, const __nv_bfloat16* xin, float* out,
                          __nv_bfloat16* xout, const __nv_bfloat16* rows, const int* row_idx, const float* residual,
                          const Ln& ln, Clk&... clk) {
  constexpr bool kLayerNorm = std::is_same_v<Ln, EpilogueNorm>;
  static_assert(kLayerNorm || std::is_same_v<Ln, decltype(nullptr)>, "an EpilogueNorm or nullptr");
  static_assert(!kLayerNorm || G == 8, "the layer norm's lanes take 8 columns");
  constexpr int NT = (G + 7) / 8;  // n-tiles of 8 columns
  const int H = a.H, MT = H / 16, ld = H + kActPad, ldf = H + kRowPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const bool active = warp < min(kMmaWarps, MT);
  float acc[kMmaMaxTiles][NT][4], bias[kMmaMaxTiles][2], gamma[kMmaMaxTiles][2], beta[kMmaMaxTiles][2];
#pragma unroll
  for (int j = 0; j < kMmaMaxTiles; ++j) {
    const int m = (warp + j * kMmaWarps) * 16 + gq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool here = active && m < H;
      bias[j][r] = here ? a.vecs[(size_t)iv * H + m + 8 * r] : 0.f;
      if constexpr (kLayerNorm) {
        gamma[j][r] = here ? a.vecs[(size_t)ln.iv * H + m + 8 * r] : 0.f;
        beta[j][r] = here ? a.vecs[(size_t)(ln.iv + 1) * H + m + 8 * r] : 0.f;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.f;
    }
  }
  if (!active) {
    st.q += st.tpl;  // the cursor stays in step; this warp reads no tile
  }
  (clk.layer(), ...);
  if constexpr (kLayerNorm) (clk.norm(), ...);
  for (int t = 0; active && t < st.tpl; ++t, ++st.q) {
    const uint4* w = st.ready(clk...);
    for (int kk = 0; kk < st.kt; ++kk) {
      const __nv_bfloat16* xk = xin + (size_t)gq * ld + (t * st.kt + kk) * 16 + 2 * tq;
      unsigned b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt][0] = *reinterpret_cast<const unsigned*>(xk + (size_t)8 * nt * ld);
        b[nt][1] = *reinterpret_cast<const unsigned*>(xk + (size_t)8 * nt * ld + 8);
      }
#pragma unroll
      for (int j = 0; j < kMmaMaxTiles; ++j) {
        const int mt = warp + j * kMmaWarps;
        if (mt < MT) {
          const uint4 f = w[((size_t)kk * MT + mt) * 32 + lane];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[j][nt], f, b[nt][0], b[nt][1]);
        }
      }
    }
    st.release();
  }
  lap<kProducts>(clk...);
#pragma unroll
  for (int j = 0; j < kMmaMaxTiles; ++j) {
    const int mt = warp + j * kMmaWarps;
    if (!active || mt >= MT) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mt * 16 + gq + 8 * (i >> 1), n = 8 * nt + 2 * tq + (i & 1);
        if (n >= G) continue;
        float v = acc[j][nt][i] + bias[j][i >> 1];
        if (rows != nullptr) v += __bfloat162float(rows[(size_t)row_idx[n] * H + m]);
        if (residual != nullptr) v += residual[n * ldf + m];
        if (out != nullptr) out[n * ldf + m] = v;
        if constexpr (kLayerNorm) {
          acc[j][nt][i] = v;
        } else if (xout != nullptr) {
          xout[(size_t)n * ld + m] = __float2bfloat16_rn(v);
        }
      }
    }
  }
  if constexpr (kLayerNorm) {
    // Lane L takes rows 8 (L & 1) to 8 (L & 1) + 7 of column (L >> 1) & 7 of the warp's m-tiles j0 + (L >> 4).
    __syncwarp();
    const int n = (lane >> 1) & 7, half = lane & 1;
#pragma unroll
    for (int j0 = 0; j0 < kMmaMaxTiles; j0 += 2) {
      const int j = j0 + (lane >> 4), mt = warp + j * kMmaWarps;
      const bool here = active && j < kMmaMaxTiles && mt < MT;
      const float4* at = reinterpret_cast<const float4*>(out + n * ldf + mt * 16 + 8 * half);
      const float4 lo = here ? at[0] : make_float4(0.f, 0.f, 0.f, 0.f), hi = here ? at[1] : lo;
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = v[e];
      float sum = tree(t);
      sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, 1));
      const float mean = __fmul_rn(sum, 0.0625f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __fsub_rn(v[e], mean);
        t[e] = __fmul_rn(d, d);
      }
      float sq = tree(t);
      sq = __fadd_rn(sq, __shfl_xor_sync(kFull, sq, 1));
      if (here && half == 0) *reinterpret_cast<float2*>(ln.stats + 2 * (mt * G + n)) = make_float2(sum, sq);
    }
  }
  sync_lap<kNorm>(clk...);
  if constexpr (kLayerNorm) {
    if (active) {
      // Lane (gq, tq) combines column 2 tq + (gq & 1) with the 3 other lanes of that column (lanes xor 8, 16): each
      // takes m-tiles gq >> 1, (gq >> 1) + 4, ... in turn (absent ones as 0), and the butterfly adds the 4 as a
      // balanced tree. Lane xor 4 holds the other column of the quad position.
      constexpr int kTurns = kMmaMaxH / 64;
      const int c = gq & 1, n = 2 * tq + c, first = gq >> 1;
      float2 p[kTurns];
      float total = 0.f, m2 = 0.f;
#pragma unroll
      for (int k = 0; k < kTurns; ++k) {
        const int mt = first + 4 * k;
        p[k] = mt < MT ? *reinterpret_cast<const float2*>(ln.stats + 2 * (mt * G + n)) : make_float2(0.f, 0.f);
        total = __fadd_rn(total, p[k].x);
      }
      total = __fadd_rn(total, __shfl_xor_sync(kFull, total, 8));
      total = __fadd_rn(total, __shfl_xor_sync(kFull, total, 16));
      const float mean = __fmul_rn(total, ln.inv_h);
#pragma unroll
      for (int k = 0; k < kTurns; ++k) {
        const float d = __fsub_rn(__fmul_rn(p[k].x, 0.0625f), mean);
        m2 = __fadd_rn(m2, first + 4 * k < MT ? __fadd_rn(p[k].y, __fmul_rn(__fmul_rn(d, d), 16.f)) : 0.f);
      }
      m2 = __fadd_rn(m2, __shfl_xor_sync(kFull, m2, 8));
      m2 = __fadd_rn(m2, __shfl_xor_sync(kFull, m2, 16));
      const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fmul_rn(m2, ln.inv_h), 1e-6f)));
      const float other_mean = __shfl_xor_sync(kFull, mean, 4), other_r = __shfl_xor_sync(kFull, r, 4);
      const float means[2] = {c ? other_mean : mean, c ? mean : other_mean};
      const float rs[2] = {c ? other_r : r, c ? r : other_r};
#pragma unroll
      for (int j = 0; j < kMmaMaxTiles; ++j) {
        const int mt = warp + j * kMmaWarps;
        if (mt >= MT) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = mt * 16 + gq + 8 * (i >> 1), col = 2 * tq + (i & 1);
          const float y = __fmul_rn(__fsub_rn(acc[j][0][i], means[i & 1]), rs[i & 1]);
          const float z = fmaxf(__fadd_rn(__fmul_rn(y, gamma[j][i >> 1]), beta[j][i >> 1]), 0.f);
          if (ln.heads != nullptr) ln.heads[m * G + col] = z;
          ln.xb[(size_t)col * ld + m] = __float2bfloat16_rn(z);
        }
      }
    }
    sync_lap<kNorm>(clk...);
  }
}

// tower on the tensor cores: the input's bfloat16 tile in_b; the result in
// xh (H, G) float, the heads' layout, and its bfloat16 rounding in xa. Every
// layer norm is taken in the epilogue of the dense layer before it (two
// barriers a layer), through `stats`. Its float input goes to x, the
// residual stream, or, for a block's first layer, to u (both (columns, H +
// kRowPad)); the layer norms write the bfloat16 tiles the next dense layers
// read (xa, then xb).
template <int G, typename... Clk>
__device__ void tower_mma(const Args& a, MmaRing& st, int iv, const __nv_bfloat16* in_b, float* x, float* u,
                          float* stats, float* xh, __nv_bfloat16* xa, __nv_bfloat16* xb, Clk&... clk) {
  const float inv_h = __fdiv_rn(1.f, (float)a.H);
  dense_mma<G>(a, st, iv, in_b, x, nullptr, nullptr, nullptr, nullptr,
               EpilogueNorm{iv + 1, inv_h, stats, xa, a.NB > 0 ? nullptr : xh}, clk...);
  iv += 1;
  for (int blk = 0; blk < a.NB; ++blk) {
    dense_mma<G>(a, st, iv + 2, xa, u, nullptr, nullptr, nullptr, nullptr,
                 EpilogueNorm{iv + 3, inv_h, stats, xb, nullptr}, clk...);
    dense_mma<G>(a, st, iv + 5, xb, x, nullptr, nullptr, nullptr, x,
                 EpilogueNorm{iv + 6, inv_h, stats, xa, blk == a.NB - 1 ? xh : nullptr}, clk...);
    iv += 6;
  }
}

// out[g] = untransform(scal[:, c] . x[:, g] + scal_b[c]), one warp per column.
template <int G, typename... Clk>
__device__ void head_scalar(const Args& a, int c, const float* x, float* out, Clk&... clk) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += compute_threads() >> 5) {
    float s = 0.f;
    for (int i = lane; i < a.H; i += 32) s = fmaf(a.scal[i * 8 + c], x[i * G + g], s);
    s = warp_sum(s) + a.scal_b[c];
    if (lane == 0) out[g] = untransform(a, s);
  }
  sync_lap<kNorm>(clk...);
}

// out[g] = untransform(sum_k softmax(cat[:, off:off+bins]^T x[:, g] + cat_b)[k] * k * step).
// `psum` holds max(split, bins) * G floats and `lg` bins * G floats, split
// the threads the input range is split over: every computing thread, but in
// the resident tensor-core library kHeadSplit.
template <int G, typename W, typename... Clk>
__device__ void head_categorical(const Args& a, int off, int bins, float step, const float* x, float* out,
                                 float* psum, float* lg, Clk&... clk) {
  const int H = a.H, T = compute_threads();
  const int split = kMma && !kStreamed ? kHeadSplit : T;
  const int nparts = bins >= split ? 1 : split / bins;  // input ranges summed by separate threads
  const int chunk = (H + nparts - 1) / nparts;
  for (int e = threadIdx.x; e < nparts * bins; e += T) {
    const int k = e % bins, part = e / bins;
    const int i0 = part * chunk, i1 = min(H, i0 + chunk);
    const W* __restrict__ w = static_cast<const W*>(a.cat) + off + k;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    for (int i = i0; i < i1; ++i) {
      const float wv = load_w(w + (size_t)i * a.CB);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(wv, act<W>(x[i * G + g]), acc[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) psum[(size_t)e * G + g] = acc[g];
  }
  sync_lap<kNorm>(clk...);
  for (int e = threadIdx.x; e < bins * G; e += T) {
    const int k = e / G, g = e % G;
    float s = 0.f;
    for (int part = 0; part < nparts; ++part) s += psum[(size_t)(part * bins + k) * G + g];
    lg[e] = s + a.cat_b[off + k];
  }
  sync_lap<kNorm>(clk...);
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += T >> 5) {
    float m = -INFINITY;
    for (int k = lane; k < bins; k += 32) m = fmaxf(m, lg[k * G + g]);
    m = warp_max(m);
    float num = 0.f, den = 0.f;
    for (int k = lane; k < bins; k += 32) {
      const float ev = expf(__fsub_rn(lg[k * G + g], m));
      den = __fadd_rn(den, ev);
      num = __fadd_rn(num, __fmul_rn(ev, __fmul_rn((float)k, step)));
    }
    num = warp_sum(num);
    den = warp_sum(den);
    if (lane == 0) out[g] = untransform(a, __fdiv_rn(num, den));
  }
  sync_lap<kNorm>(clk...);
}

// The value (c = 0), Q (c = 1) or reward (c = 2) head, scalar (float32
// weights and activations, whatever W is) or categorical.
template <int G, typename W, typename... Clk>
__device__ void head_value(const Args& a, int c, const float* x, float* out, float* psum, float* lg,
                           Clk&... clk) {
  const int bins = c == 2 ? a.reward_bins : a.value_bins;
  if (bins == 1) {
    head_scalar<G>(a, c, x, out, clk...);
    return;
  }
  const int off = a.value_bins > 1 ? c * a.value_bins : 0;
  head_categorical<G, W>(a, off, bins, c == 2 ? a.reward_step : a.value_step, x, out, psum, lg, clk...);
}

// logits (K, G) = wide[j]^T x + wide_b[:, j].
template <int G, typename W, typename... Clk>
__device__ void head_logits(const Args& a, int j, const float* x, float* logits, Clk&... clk) {
  for (int e = threadIdx.x; e < a.K * G; e += compute_threads()) {
    const int k = e / G, g = e % G;
    const W* w = static_cast<const W*>(a.wide) + (size_t)j * a.H * a.K + k;
    float s = 0.f;
    for (int i = 0; i < a.H; ++i) s = fmaf(to_f(w[(size_t)i * a.K]), act<W>(x[i * G + g]), s);
    logits[e] = s + a.wide_b[k * 2 + j];
  }
  sync_lap<kNorm>(clk...);
}

// Floats of shared memory the categorical heads take beside the rest: partial
// sums for max(threads, bins) x G and the (bins, G) logits of one head.
inline int cat_scratch_floats(int H, int G, int value_bins, int reward_bins) {
  const int bins = (value_bins > reward_bins ? value_bins : reward_bins);
  if (bins <= 1) return 0;
  const int threads = 2 * H;
  return ((threads > bins ? threads : bins) + bins) * G;
}

template <int G>
size_t smem_bytes(int H, int K, int value_bins, int reward_bins, int tile_floats) {
  return (size_t)(tile_floats + 7 * H * G + 2 * K * G + 3 * G + cat_scratch_floats(H, G, value_bins, reward_bins)) *
             sizeof(float) +
         (size_t)7 * G * sizeof(int);
}

// The tree steps both kernels take around their expansions, on the tree
// tables in global memory: tree init, traversal, the new node's priors,
// backup and root statistics. Only the expansion differs between the
// kernels: how the parent embeddings are gathered, how the dense layers run,
// and how the new node's embedding is installed.
//
// Where a simulation's traversal leaves each of the block's G searches, for
// the expansion and the backup: (G,) arrays in shared memory.
struct Picks {
  int *parent, *edge, *exist, *depth, *dec, *arow, *crow;
};

// Tree init: the root of search b0 + g is node 0, a decision node.
template <int G, typename W, typename... Clk>
__device__ __forceinline__ void tree_init(const Args& a, int b0, Clk&... clk) {
  const int H = a.H, K = a.K, N = a.S + 1;
  const int tid = threadIdx.x;
  W* emb = static_cast<W*>(a.emb);
  for (int g = 0; g < G && b0 + g < a.B; ++g) {
    const int b = b0 + g;
    const size_t nk = (size_t)b * N * K, nn = (size_t)b * N;
    for (int e = tid; e < N * K; e += compute_threads()) {
      a.cidx[nk + e] = kUnvisited;
      a.cvis[nk + e] = 0.f;
      a.cval[nk + e] = 0.f;
      a.prior[nk + e] = e < K ? a.root_p[(size_t)b * K + e] : 0.f;
    }
    for (int e = tid; e < N; e += compute_threads()) {
      a.nvis[nn + e] = e == 0 ? 1.f : 0.f;
      a.nval[nn + e] = e == 0 ? a.root_v[b] : 0.f;
      a.nrew[nn + e] = 0.f;
      a.ndis[nn + e] = 1.f;
      a.ndec[nn + e] = e == 0 ? 1.f : 0.f;
    }
    for (int e = tid; e < H; e += compute_threads()) emb[nn * H + e] = from_f<W>(a.root_h[(size_t)b * H + e]);
  }
  sync_lap<kTree>(clk...);
}

// Traversal, one warp per search: the leaf each search expands, in `p`.
template <int G, typename... Clk>
__device__ __forceinline__ void traverse(const Args& a, int b0, const Picks& p, Clk&... clk) {
  const int K = a.K, A = a.A, N = a.S + 1, P = a.P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = compute_threads() >> 5;
  for (int g = warp; g < G; g += nwarps) {
    const int b = b0 + g;
    if (b >= a.B) {
      if (lane == 0) {
        p.parent[g] = 0;
        p.edge[g] = 0;
        p.exist[g] = 0;
        p.depth[g] = 1;
        p.dec[g] = 1;
        p.arow[g] = 0;
        p.crow[g] = 0;
      }
      continue;
    }
    int* pn = a.path_nodes + (size_t)b * P;
    int* pe_ = a.path_edges + (size_t)b * P;
    int node = 0, edge, next;
    pick(a, b, node, lane, edge, next);
    if (lane == 0) {
      pn[0] = node;
      pe_[0] = edge;
    }
    int depth = 1;
    while (depth < P && next != kUnvisited) {
      node = next;
      pick(a, b, node, lane, edge, next);
      if (lane == 0) {
        pn[depth] = node;
        pe_[depth] = edge;
      }
      ++depth;
    }
    if (lane == 0) {
      p.parent[g] = node;
      p.edge[g] = edge;
      p.exist[g] = next;
      p.depth[g] = depth;
      p.dec[g] = a.ndec[(size_t)b * N + node] > 0.f ? 1 : 0;
      p.arow[g] = min(edge, A - 1);
      p.crow[g] = min(edge, K - 1);
    }
  }
  sync_lap<kTree>(clk...);
}

// The new nodes' priors at row new_index: a softmax of the chance logits
// (lc) after a decision parent, of the action logits (la) after a chance one.
template <int G, typename... Clk>
__device__ __forceinline__ void priors(const Args& a, int b0, int new_index, const int* s_dec, const float* lc,
                                       const float* la, Clk&... clk) {
  const int K = a.K, A = a.A, N = a.S + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = compute_threads() >> 5;
  for (int g = warp; g < G; g += nwarps) {
    const int b = b0 + g;
    if (b >= a.B) continue;
    const bool dec = s_dec[g];
    const int width = dec ? K : A;
    const float* logits = dec ? lc : la;
    const float m = lane < width ? __fdiv_rn(logits[lane * G + g], a.temperature) : kNegInf;
    const float mx = warp_max(m);
    const float ev = lane < width ? expf(__fsub_rn(m, mx)) : 0.f;
    const float sum = warp_sum(ev);
    if (lane < K) a.prior[((size_t)b * N + new_index) * K + lane] = __fdiv_rn(ev, sum);
  }
  lap<kNorm>(clk...);
}

// The backup, one thread per search: the new node's statistics, then the
// path's values, visits and edges.
template <int G, typename... Clk>
__device__ __forceinline__ void backup(const Args& a, int b0, int new_index, const Picks& p, const float* s_q,
                                       const float* s_r, const float* s_v, Clk&... clk) {
  const int K = a.K, N = a.S + 1, P = a.P;
  const int tid = threadIdx.x;
  if (tid < G && b0 + tid < a.B) {
    const int g = tid, b = b0 + g;
    const size_t nb = (size_t)b * N;
    const bool dec = p.dec[g];
    a.nrew[nb + new_index] = dec ? 0.f : s_r[g];
    a.ndis[nb + new_index] = dec ? 1.f : a.discount;
    a.ndec[nb + new_index] = dec ? 0.f : 1.f;

    const int exist = p.exist[g], parent = p.parent[g], edge = p.edge[g], depth = p.depth[g];
    const bool needs_expand = exist == kUnvisited;
    const int child = needs_expand ? new_index : exist;
    if (needs_expand) a.cidx[(nb + parent) * K + edge] = child;
    const float leaf_value = needs_expand ? (dec ? s_q[g] : s_v[g]) : a.nval[nb + max(exist, 0)];

    const int* pn = a.path_nodes + (size_t)b * P;
    const int* pe_ = a.path_edges + (size_t)b * P;
    float* vb = a.vbuf + (size_t)b * (P + 1);
    auto ext = [&](int j) { return j < depth ? pn[j] : (j == depth ? child : N); };

    vb[depth] = leaf_value;
    for (int j = depth - 1; j >= 0; --j) {
      const int nd = ext(j + 1);
      vb[j] = __fadd_rn(a.nrew[nb + nd], __fmul_rn(a.ndis[nb + nd], vb[j + 1]));
    }
    for (int j = 0; j <= depth; ++j) {
      const int nd = ext(j);
      const float vis = a.nvis[nb + nd];
      const float val = a.nval[nb + nd];
      a.nval[nb + nd] = __fdiv_rn(__fadd_rn(__fmul_rn(val, vis), vb[j]), __fadd_rn(vis, 1.f));
      a.nvis[nb + nd] = vis + 1.f;
    }
    for (int j = 0; j < depth; ++j) {
      const int nd = pn[j], cn = ext(j + 1);
      const size_t ek = (nb + nd) * K + pe_[j];
      a.cvis[ek] += 1.f;
      a.cval[ek] = __fadd_rn(a.nrew[nb + cn], __fmul_rn(a.ndis[nb + cn], a.nval[nb + cn]));
    }
  }
  sync_lap<kTree>(clk...);
}

// Root visits and Q of every action, and the root value.
template <int G, typename... Clk>
__device__ __forceinline__ void root_stats(const Args& a, int b0, Clk&... clk) {
  const int K = a.K, A = a.A, N = a.S + 1;
  const int tid = threadIdx.x;
  for (int e = tid; e < G * A; e += compute_threads()) {
    const int g = e / A, act = e % A, b = b0 + g;
    if (b < a.B) {
      a.visits[(size_t)b * A + act] = a.cvis[(size_t)b * N * K + act];
      a.qvals[(size_t)b * A + act] = a.cval[(size_t)b * N * K + act];
    }
  }
  if (tid < G && b0 + tid < a.B) a.rootv[b0 + tid] = a.nval[(size_t)(b0 + tid) * N];
  lap<kTree>(clk...);
}

// The streamed kernel's tile: T rows of each input half, the largest power
// of two times 16 that divides H / 2 with both halves in kTileBytes.
inline int stream_tile_rows(int H) {
  int T = 16;
  while ((H / 2) % (2 * T) == 0 && 2 * (2 * T) * H * (int)sizeof(float) <= kTileBytes) T *= 2;
  return T;
}

// The ring's kernel runs 2H <= 512 computing threads and a producer warp,
// one block an SM (its stages take 192 KB of shared memory), so it may take
// 65,536 / 544 registers a thread: without the 1, ptxas keeps 64 and spills.
// The float32 streamed kernel runs 2H <= 1,024 threads.
#if !WHOLE_SEARCH_STREAMED
#define WHOLE_SEARCH_BOUNDS __launch_bounds__(544, 1)
#else
#define WHOLE_SEARCH_BOUNDS __launch_bounds__(1024)
#endif

// The float32 libraries' kernel, its dense layers fed by a Feed: the
// resident library's Ring, the streamed one's Stream. Shared memory, after
// the weight tiles: (H, G) float tiles of the parent embeddings, the
// afterstate, the next hidden state, the tower's three activations and the
// second input half's partial sums, then the logits and head values, the
// categorical heads' scratch and the traversal's picks.
template <int G, typename Feed, typename... Clk>
__global__ void WHOLE_SEARCH_BOUNDS whole_search_kernel(Args a, Clk... clk) {
  (clk.begin(), ...);
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, K = a.K, N = a.S + 1;
  const int HG = H * G;
  float* emb = static_cast<float*>(a.emb);
  float* pe = smem + a.tile_floats;  // parent embeddings
  float* after = pe + HG;    // phi output (afterstate)
  float* hnew = after + HG;  // g output (next hidden state)
  float* x = hnew + HG;      // tower activations
  float* t = x + HG;
  float* u = t + HG;
  float* part = u + HG;      // partial sums of the second input half
  float* lc = part + HG;     // (K, G) chance logits
  float* la = lc + K * G;    // (K, G) action logits
  float* s_q = la + K * G;
  float* s_r = s_q + G;
  float* s_v = s_r + G;
  float* psum = s_v + G;  // categorical heads: partial sums, then the (bins, G) logits
  const int cat_bins = max(a.value_bins, a.reward_bins);
  const int cat_floats = cat_bins > 1 ? (max((int)compute_threads(), cat_bins) + cat_bins) * G : 0;
  float* lgt = psum + (cat_floats - cat_bins * G);
  int* s_int = reinterpret_cast<int*>(s_v + G + cat_floats);
  const Picks picks{s_int, s_int + G, s_int + 2 * G, s_int + 3 * G, s_int + 4 * G, s_int + 5 * G, s_int + 6 * G};

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * G;

  // Offsets into the bias / LayerNorm vectors (mirror pack_search_params).
  const int tower_hh = 1 + 2 * a.NB, tower_vec = 3 + 6 * a.NB;
  const int F_V = 0, PHI_FUSE_V = F_V + tower_vec, PHI_V = PHI_FUSE_V + 1, PHI_HEAD_V = PHI_V + tower_vec;
  const int PSI_V = PHI_HEAD_V + 1, G_FUSE_V = PSI_V + tower_vec, G_V = G_FUSE_V + 1, G_HEAD_V = G_V + tower_vec;
  const float* win = static_cast<const float*>(a.win);

  Feed st{};
  if constexpr (kRing) {
    st.start(a, smem, tower_hh);
    if (tid >= (int)compute_threads()) {  // the producer warp
      if ((tid & 31) == 0) st.produce(a, clk...);
      (clk.flush(), ...);
      return;
    }
  } else {
    st = Feed{smem, a.tile_rows, H / 2 / a.tile_rows, (4 * tower_hh + 4) * (H / 2 / a.tile_rows), 0};
  }

  tree_init<G, float>(a, b0, clk...);

  for (int new_index = 1; new_index <= a.S; ++new_index) {  // a simulation: its new node takes row new_index
    if constexpr (kStreamed) {  // the expansion's first tile lands while the block traverses
      st.q = 0;
      st.issue(a, 0);
    }
    traverse<G>(a, b0, picks, clk...);

    // ---- expansion: both transition types at (parent, edge), the layers in call order
    for (int e = tid; e < HG; e += compute_threads()) {
      const int i = e / G, g = e % G, b = b0 + g;
      pe[e] = b < a.B ? emb[((size_t)b * N + picks.parent[g]) * H + i] : 0.f;
    }
    sync_lap<kTree>(clk...);

    // phi then psi (decision parent -> chance child)
    dense<G>(a, st, PHI_FUSE_V, pe, u, part, win, picks.arow, false, clk...);
    tower<G>(a, st, PHI_V, u, x, t, u, part, clk...);
    dense<G>(a, st, PHI_HEAD_V, x, after, part, nullptr, nullptr, false, clk...);
    tower<G>(a, st, PSI_V, after, x, t, u, part, clk...);
    head_value<G, float>(a, 1, x, s_q, psum, lgt, clk...);
    head_logits<G, float>(a, 1, x, lc, clk...);

    // g then f (chance parent -> decision child)
    dense<G>(a, st, G_FUSE_V, pe, u, part, win + (size_t)K * H, picks.crow, false, clk...);
    tower<G>(a, st, G_V, u, x, t, u, part, clk...);
    dense<G>(a, st, G_HEAD_V, x, hnew, part, nullptr, nullptr, false, clk...);
    head_value<G, float>(a, 2, x, s_r, psum, lgt, clk...);
    tower<G>(a, st, F_V, hnew, x, t, u, part, clk...);
    head_value<G, float>(a, 0, x, s_v, psum, lgt, clk...);
    head_logits<G, float>(a, 0, x, la, clk...);

    // ---- install the new node at row new_index (unreachable when the
    // depth cap stopped on an expanded edge)
    for (int e = tid; e < HG; e += compute_threads()) {
      const int i = e / G, g = e % G, b = b0 + g;
      if (b < a.B) emb[((size_t)b * N + new_index) * H + i] = picks.dec[g] ? after[e] : hnew[e];
    }
    lap<kTree>(clk...);
    priors<G>(a, b0, new_index, picks.dec, lc, la, clk...);
    backup<G>(a, b0, new_index, picks, s_q, s_r, s_v, clk...);
    (clk.settle(), ...);
  }

  root_stats<G>(a, b0, clk...);
  (clk.flush(), ...);
}

// The tensor-core libraries' kernel (bfloat16 packs, variants (c) resident
// and (d) streamed, which differ only in their copy of the layers and their
// compile-time shape): the search of
// whole_search_kernel with its dense layers on the tensor cores, fed by an
// MmaRing that runs across layers and simulations. kMmaWarps reading warps
// compute; a producer warp copies the fragments. Shared memory, after the
// ring: the residual stream x (columns, H + kRowPad) float, a tower's
// output xh (H, G) float for the heads, the logits and head values, the
// traversal's picks, the bfloat16 tiles (columns, H + kActPad) of the
// parent embeddings, the afterstate and the next hidden state (what the
// install copies to the table), then u (columns, H + kRowPad) float, the
// layer norms' m-tile statistics (H floats; every region here is 16-byte
// aligned) and the bfloat16 tiles xa and xb, over which the categorical heads
// keep their partial sums (none of the four is live during a head).
template <int G, typename... Clk>
__global__ void __launch_bounds__(32 * (kMmaWarps + 1), 1) whole_search_mma_kernel(Args a, Clk... clk) {
  (clk.begin(), ...);
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, K = a.K, N = a.S + 1;
  const int HG = H * G, ld = H + kActPad, tile = 8 * ((G + 7) / 8) * ld;  // a bfloat16 tile's elements
  const int rows = G * (H + kRowPad);                                      // a float tile's elements
  bf16* emb = static_cast<bf16*>(a.emb);
  float* x = smem + a.tile_floats;
  float* xh = x + rows;
  float* lc = xh + HG;     // (K, G) chance logits
  float* la = lc + K * G;  // (K, G) action logits
  float* s_q = la + K * G;
  float* s_r = s_q + G;
  float* s_v = s_r + G;
  int* s_int = reinterpret_cast<int*>(s_v + G);
  const Picks picks{s_int, s_int + G, s_int + 2 * G, s_int + 3 * G, s_int + 4 * G, s_int + 5 * G, s_int + 6 * G};
  bf16* pe_b = reinterpret_cast<bf16*>(s_int + 7 * G);
  bf16* after_b = pe_b + tile;
  bf16* hnew_b = after_b + tile;
  float* u = reinterpret_cast<float*>(hnew_b + tile);
  float* stats = u + rows;  // (H / 16, G) float2s
  bf16* xa = reinterpret_cast<bf16*>(stats + H);
  bf16* xb = xa + tile;
  float* psum = u;  // categorical heads: partial sums, then the (bins, G) logits
  const int cat_bins = max(a.value_bins, a.reward_bins);
  const int split = kMma && !kStreamed ? kHeadSplit : (int)compute_threads();
  const int cat_floats = cat_bins > 1 ? (max(split, cat_bins) + cat_bins) * G : 0;
  float* lgt = psum + (cat_floats - cat_bins * G);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * G;

  // Offsets into the bias / LayerNorm vectors (mirror pack_search_params).
  const int tower_vec = 3 + 6 * a.NB, n_real = 4 * (1 + 2 * a.NB) + 4;
  const int F_V = 0, PHI_FUSE_V = F_V + tower_vec, PHI_V = PHI_FUSE_V + 1, PHI_HEAD_V = PHI_V + tower_vec;
  const int PSI_V = PHI_HEAD_V + 1, G_FUSE_V = PSI_V + tower_vec, G_V = G_FUSE_V + 1, G_HEAD_V = G_V + tower_vec;
  const bf16* win = static_cast<const bf16*>(a.win);

  MmaRing st;
  st.start(a.hh, smem, H, 0, n_real, a.S * n_real, min(kMmaWarps, H / 16));
  if (tid >= (int)compute_threads()) {  // the producer warp
    if ((tid & 31) == 0) st.produce(clk...);
    (clk.flush(), ...);
    return;
  }

  tree_init<G, bf16>(a, b0, clk...);

  for (int sim = 0; sim < a.S; ++sim) {
    const int new_index = sim + 1;
    traverse<G>(a, b0, picks, clk...);

    // ---- expansion: both transition types at (parent, edge), the layers in call order
    for (int e = tid; e < HG; e += compute_threads()) {
      const int g = e / H, i = e % H, b = b0 + g;
      pe_b[(size_t)g * ld + i] = b < a.B ? emb[((size_t)b * N + picks.parent[g]) * H + i] : __float2bfloat16_rn(0.f);
    }
    sync_lap<kTree>(clk...);

    // phi then psi (decision parent -> chance child)
    dense_mma<G>(a, st, PHI_FUSE_V, pe_b, nullptr, xa, win, picks.arow, nullptr, nullptr, clk...);
    tower_mma<G>(a, st, PHI_V, xa, x, u, stats, xh, xa, xb, clk...);
    dense_mma<G>(a, st, PHI_HEAD_V, xa, nullptr, after_b, nullptr, nullptr, nullptr, nullptr, clk...);
    tower_mma<G>(a, st, PSI_V, after_b, x, u, stats, xh, xa, xb, clk...);
    head_value<G, bf16>(a, 1, xh, s_q, psum, lgt, clk...);
    head_logits<G, bf16>(a, 1, xh, lc, clk...);

    // g then f (chance parent -> decision child)
    dense_mma<G>(a, st, G_FUSE_V, pe_b, nullptr, xa, win + (size_t)K * H, picks.crow, nullptr, nullptr, clk...);
    tower_mma<G>(a, st, G_V, xa, x, u, stats, xh, xa, xb, clk...);
    dense_mma<G>(a, st, G_HEAD_V, xa, nullptr, hnew_b, nullptr, nullptr, nullptr, nullptr, clk...);
    head_value<G, bf16>(a, 2, xh, s_r, psum, lgt, clk...);
    tower_mma<G>(a, st, F_V, hnew_b, x, u, stats, xh, xa, xb, clk...);
    head_value<G, bf16>(a, 0, xh, s_v, psum, lgt, clk...);
    head_logits<G, bf16>(a, 0, xh, la, clk...);

    // ---- install the new node at row new_index: the bfloat16 values the next products read
    for (int e = tid; e < HG; e += compute_threads()) {
      const int g = e / H, i = e % H, b = b0 + g;
      if (b < a.B) emb[((size_t)b * N + new_index) * H + i] = (picks.dec[g] ? after_b : hnew_b)[(size_t)g * ld + i];
    }
    lap<kTree>(clk...);
    priors<G>(a, b0, new_index, picks.dec, lc, la, clk...);
    backup<G>(a, b0, new_index, picks, s_q, s_r, s_v, clk...);
    (clk.settle(), ...);
  }

  root_stats<G>(a, b0, clk...);
  (clk.flush(), ...);
}

// The dense probe: block l runs dense_mma on layer l of the fragment copy
// `frag` (n_layers layers), with bias row l of `bias` (n_layers, H) and the
// activations x (G, H) float rounded to bfloat16; out (n_layers, G, H + kRowPad).
template <int G>
__global__ void __launch_bounds__(32 * (kMmaWarps + 1), 1)
    dense_probe_kernel(const void* frag, const float* bias, const float* x, float* out, int H, int n_layers) {
  extern __shared__ __align__(16) float smem[];
  Args a{};
  a.H = H;
  a.vecs = bias;
  MmaRing st;
  st.start(frag, smem, H, blockIdx.x, n_layers, 1, min(kMmaWarps, H / 16));
  if (threadIdx.x >= compute_threads()) {
    if ((threadIdx.x & 31) == 0) st.produce();
    return;
  }
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem + mma_ring_floats(H));
  for (int e = threadIdx.x; e < G * H; e += compute_threads()) {
    xb[(size_t)(e / H) * (H + kActPad) + e % H] = __float2bfloat16_rn(x[e]);
  }
  block_sync();
  dense_mma<G>(a, st, blockIdx.x, xb, out + (size_t)blockIdx.x * G * (H + kRowPad), nullptr, nullptr, nullptr, nullptr,
               nullptr);
}

// The ring's tile: T rows of each input half, the largest power of two times
// 8 that divides H / 2 with both halves in kRingStageBytes.
inline int ring_tile_rows(int H) {
  int T = 8;
  while ((H / 2) % (2 * T) == 0 && 2 * (2 * T) * H * (int)sizeof(float) <= kRingStageBytes) T *= 2;
  return T;
}

// How a launch of B searches runs: blocks (one per G searches; the last
// block's searches past B are dummies that run the whole pipeline), threads
// a block, the weight stages in shared memory and a tile's rows (of each
// input half; the tensor-core kernel: input rows of every output), the
// floats before the activations in shared memory, and the dynamic shared
// memory.
struct Plan {
  int blocks, threads, stages, tile_rows, tile_floats;
  size_t smem;
};

// This library's plan.
inline Plan make_plan(int B, int H, int K, int value_bins, int reward_bins) {
  constexpr int G = kSearchesPerBlock;
  Plan p{(B + G - 1) / G, 0, 0, 0, 0, 0};
  if constexpr (kMma) {  // whole_search_mma_kernel's shared memory
    const int threads = 32 * kMmaWarps, tile = 8 * ((G + 7) / 8) * (H + kActPad);
    const int split = kStreamed ? threads : kHeadSplit;
    const int bins = value_bins > reward_bins ? value_bins : reward_bins;
    const size_t cat = bins > 1 ? (size_t)((split > bins ? split : bins) + bins) * G * sizeof(float) : 0;
    const int rows = G * (H + kRowPad);
    // u, the layer norms' statistics, xa and xb
    const size_t scratch = (size_t)(rows + H) * sizeof(float) + 2 * (size_t)tile * sizeof(__nv_bfloat16);
    p.threads = threads + 32;  // and the producer warp
    p.stages = kMmaStages;
    p.tile_rows = 16 * mma_tile_ksteps(H);
    p.tile_floats = mma_ring_floats(H);
    p.smem = (size_t)(p.tile_floats + rows + H * G + 2 * K * G + 3 * G) * sizeof(float) + (size_t)7 * G * sizeof(int) +
             3 * (size_t)tile * sizeof(__nv_bfloat16) + (cat > scratch ? cat : scratch);
    return p;
  }
  if constexpr (kRing) {
    p.threads = 2 * H + 32;  // and the producer warp
    p.stages = kStages;
    p.tile_rows = ring_tile_rows(H);
    p.tile_floats = kStages * 2 * p.tile_rows * H + kBarrierFloats + 2 * H;  // and the layer norm's vectors
  } else {
    p.threads = 2 * H;
    p.stages = 2;
    p.tile_rows = stream_tile_rows(H);
    p.tile_floats = 2 * 2 * p.tile_rows * H;
  }
  p.smem = smem_bytes<G>(H, K, value_bins, reward_bins, p.tile_floats);
  return p;
}

// This library's kernel: unclocked, or clocked with a Clock type.
template <typename... Clk>
auto library_kernel() {
#if WHOLE_SEARCH_BF16
  return whole_search_mma_kernel<kSearchesPerBlock, Clk...>;
#else
  return whole_search_kernel<kSearchesPerBlock, std::conditional_t<kRing, Ring, Stream>, Clk...>;
#endif
}

// The launch of the unclocked kernel, or with a Clock (clk) the clocked one.
template <typename... Clk>
int launch(Args a, cudaStream_t stream, Clk... clk) {
  const Plan p = make_plan(a.B, a.H, a.K, a.value_bins, a.reward_bins);
  a.tile_rows = p.tile_rows;
  a.tile_floats = p.tile_floats;
  const auto kernel = library_kernel<Clk...>();
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.blocks, p.threads, p.smem, stream>>>(a, clk...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tree tables' bytes (node embeddings in this library's weight type).
size_t whole_search_workspace_bytes(int B, int H, int K, int S, int P) {
  return make_layout(B, H, K, S, P, sizeof(Weight)).words * sizeof(float);
}

const char* whole_search_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// How a launch of B searches at these widths runs: out[0..6] = blocks,
// threads a block, searches per block (G), weight stages in shared memory,
// rows of each input half per tile (the tensor-core kernel: input rows of
// every output), blocks resident on the card at once, dynamic shared memory
// bytes per block. Returns 0 or a CUDA error code.
int whole_search_launch_shape(int B, int H, int K, int value_bins, int reward_bins, int* out) {
  const Plan p = make_plan(B, H, K, value_bins, reward_bins);
  const auto kernel = library_kernel<>();
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, p.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int values[7] = {p.blocks, p.threads, kSearchesPerBlock, p.stages, p.tile_rows, per_sm * sms, (int)p.smem};
  for (int i = 0; i < 7; ++i) out[i] = values[i];
  return 0;
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for shapes the kernel does not take and for a
// variant this library was not built for. hh, win, wide and cat are bfloat16
// when weight_bf16 is 1, else float32; with streamed = 1, hh holds the
// 4 (1 + 2 NB) + 4 layers in call order (any zero padding after them is
// never read). With `clocks` (kCounters int64s, zeroed) the clocked kernel
// runs and adds its phase clocks there; with null, the unclocked one.
int whole_search_launch(const float* root_h, const float* root_p, const float* root_v, const void* hh,
                        const float* vecs, const void* win, const void* wide, const float* wide_b,
                        const float* scal, const float* scal_b, const void* cat, const float* cat_b,
                        float* visits, float* qvals, float* rootv, void* workspace, int B, int H, int NB, int S,
                        int K, int A, int P, int CB, int value_bins, int reward_bins, int weight_bf16, int streamed,
                        float pb_c_init, float pb_c_base, float discount, float temperature, float value_step,
                        float reward_step, int has_eps, float eps, float four_eps, float two_eps, void* clocks,
                        void* stream) {
  if (weight_bf16 != WHOLE_SEARCH_BF16 || streamed != WHOLE_SEARCH_STREAMED || B < 1 || H < 32 || H % 32 != 0 ||
      2 * H > (kStreamed ? 1024 : 512) || K < 1 || K > 32 || A < 1 || A > K ||
      S < 1 || P < 1 ||
      P > S + 1 || NB < 0 || value_bins < 1 || value_bins > 512 || reward_bins < 1 || reward_bins > 512 ||
      CB < (value_bins > 1 ? 2 * value_bins : 0) + (reward_bins > 1 ? reward_bins : 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = make_layout(B, H, K, S, P, sizeof(Weight));
  float* ws = static_cast<float*>(workspace);
  Args a{};
  a.root_h = root_h;
  a.root_p = root_p;
  a.root_v = root_v;
  a.hh = hh;
  a.vecs = vecs;
  a.win = win;
  a.wide = wide;
  a.wide_b = wide_b;
  a.scal = scal;
  a.scal_b = scal_b;
  a.cat = cat;
  a.cat_b = cat_b;
  a.visits = visits;
  a.qvals = qvals;
  a.rootv = rootv;
  a.emb = ws + L.emb;
  a.prior = ws + L.prior;
  a.cidx = reinterpret_cast<int*>(ws + L.cidx);
  a.cvis = ws + L.cvis;
  a.cval = ws + L.cval;
  a.nvis = ws + L.nvis;
  a.nval = ws + L.nval;
  a.nrew = ws + L.nrew;
  a.ndis = ws + L.ndis;
  a.ndec = ws + L.ndec;
  a.path_nodes = reinterpret_cast<int*>(ws + L.path_nodes);
  a.path_edges = reinterpret_cast<int*>(ws + L.path_edges);
  a.vbuf = ws + L.vbuf;
  a.B = B;
  a.H = H;
  a.NB = NB;
  a.S = S;
  a.K = K;
  a.A = A;
  a.P = P;
  a.n_vec = 4 * (3 + 6 * NB) + 4;
  a.CB = CB;
  a.value_bins = value_bins;
  a.reward_bins = reward_bins;
  a.value_step = value_step;
  a.reward_step = reward_step;
  a.pb_c_init = pb_c_init;
  a.pb_c_base = pb_c_base;
  a.discount = discount;
  a.temperature = temperature;
  a.has_eps = has_eps;
  a.eps = eps;
  a.four_eps = four_eps;
  a.two_eps = two_eps;
  if (clocks != nullptr) {
    Clock clk{};
    clk.out = static_cast<unsigned long long*>(clocks);
    return launch(a, static_cast<cudaStream_t>(stream), clk);
  }
  return launch(a, static_cast<cudaStream_t>(stream));
}

#if WHOLE_SEARCH_BF16
// The dense probe (dense_probe_kernel): out (n_layers, G, H + kRowPad) = each layer of
// the fragment copy `frag` applied to x (G, H), rounded to bfloat16, plus
// its row of `bias` (n_layers, H), by the search kernel's own ring, mma.sync
// products and epilogue, G = the library's searches a block. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
int whole_search_dense_probe(const void* frag, const float* bias, const float* x, float* out, int H, int n_layers,
                             void* stream) {
  if (H < 32 || H > kMmaMaxH || H % 32 != 0 || n_layers < 1) return (int)cudaErrorInvalidValue;
  constexpr int G = kSearchesPerBlock;
  const size_t smem = (size_t)mma_ring_floats(H) * sizeof(float) +
                      (size_t)8 * ((G + 7) / 8) * (H + kActPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(dense_probe_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_probe_kernel<G><<<n_layers, 32 * (kMmaWarps + 1), smem, static_cast<cudaStream_t>(stream)>>>(
      frag, bias, x, out, H, n_layers);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
