// Random-rollout kernel for Hopper (sm_90a): num_steps uniform-random
// auto-reset 2048 steps per board in one launch, every board's state in its
// thread's registers from the first step to the last.
//
// Replaces the TPU kernel simulate_2048_tpu/ops/pallas_rollout.py
// (_rollout_kernel / pallas_random_rollout) and computes, bit for bit, what
// ops/rollout_kernel.py's random_rollout_reference computes: per board the
// final board, the episodes finished, the reward sum (float32, added in step
// order) and the largest tile seen after a step and before a reset.
//
// What bounds it: 32-bit integer operations. A board reads 8 bytes (its seed)
// and writes 76 (board, episodes, reward sum, max tile) whatever the number
// of steps, while every step costs two Threefry-2x32 of 20 rounds (the action
// and, when the board moved, the spawn) plus the slide, the spawn and the
// end-of-game test. So the design keeps memory out of the loop and the loop
// short:
// - one thread per board, any batch size (the last block is masked);
// - the board is four uint32, one per row, one byte per cell (exponents stay
//   far below 128): transposing and mirroring are __byte_perm, the tests for
//   empty cells and equal neighbours are SWAR bit tricks on whole rows;
// - a move in any direction is "orient, slide the four rows left, orient
//   back": bit 0 of the action transposes, bit 1 mirrors, both selected
//   without a branch, so that the threads of a warp stay together whatever
//   directions their boards drew;
// - the spawn's Threefry runs only where the board moved, and the reseed's
//   Threefry and the fresh board only where a game ended (a branch on done);
// - native unsigned arithmetic: __umulhi for the spawn rank, an unsigned
//   compare for the 2-or-4 choice, __funnelshift_l for the rotations.
//
// Plain C interface at the bottom; loaded with ctypes (ops/rollout_kernel.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSpawnStream = 0x20480001u;
constexpr uint32_t kGameSeedStream = 0x20480002u;
constexpr uint32_t kActionStream = 0x20480003u;
constexpr uint32_t kFourThreshold = 429496730u;  // P(spawn a 4) = 0.1 as a uint32 threshold
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kThreads = 128;

#define TF_ROUND(d)                 \
  x0 += x1;                         \
  x1 = __funnelshift_l(x1, x1, d);  \
  x1 ^= x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)

// Threefry-2x32, 20 rounds (Salmon et al., SC'11): the bijection of ops/rng.py.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1, uint32_t& o0,
                                             uint32_t& o1) {
  const uint32_t k2 = kParity ^ k0 ^ k1;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  TF_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

struct Board {
  uint32_t r[4];  // row-major: cell (row, col) is byte col of r[row]
};

// Bit 7 of every byte of v that is not zero (bytes must be below 0x80).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) { return (v + 0x7F7F7F7Fu) & 0x80808080u; }

__device__ __forceinline__ int count_empty(const Board& b) {
  return 16 - __popc(nonzero_bytes(b.r[0])) - __popc(nonzero_bytes(b.r[1])) - __popc(nonzero_bytes(b.r[2])) -
         __popc(nonzero_bytes(b.r[3]));
}

__device__ __forceinline__ Board transpose(const Board& b) {
  const uint32_t lo01 = __byte_perm(b.r[0], b.r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t hi01 = __byte_perm(b.r[0], b.r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t lo23 = __byte_perm(b.r[2], b.r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(b.r[2], b.r[3], 0x7362);
  Board t;
  t.r[0] = __byte_perm(lo01, lo23, 0x5410);
  t.r[1] = __byte_perm(lo01, lo23, 0x7632);
  t.r[2] = __byte_perm(hi01, hi23, 0x5410);
  t.r[3] = __byte_perm(hi01, hi23, 0x7632);
  return t;
}

// Left for action 0, up for 1, right for 2, down for 3 become "left" on the
// oriented board: bit 0 transposes, then bit 1 mirrors every row.
__device__ __forceinline__ Board orient(const Board& b, uint32_t action) {
  const Board t = transpose(b);
  Board o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t row = (action & 1u) ? t.r[i] : b.r[i];
    o.r[i] = (action & 2u) ? __byte_perm(row, 0u, 0x0123) : row;
  }
  return o;
}

__device__ __forceinline__ Board unorient(const Board& o, uint32_t action) {
  Board m;
#pragma unroll
  for (int i = 0; i < 4; ++i) m.r[i] = (action & 2u) ? __byte_perm(o.r[i], 0u, 0x0123) : o.r[i];
  const Board t = transpose(m);
  Board b;
#pragma unroll
  for (int i = 0; i < 4; ++i) b.r[i] = (action & 1u) ? t.r[i] : m.r[i];
  return b;
}

// Slide one row towards byte 0: tiles keep their order, equal neighbours merge
// once, left to right; a merge of two 2^e tiles scores 2^(e+1) = 2 << e.
__device__ __forceinline__ uint32_t slide_row_left(uint32_t row, int& score) {
  uint32_t out = 0u;
  uint32_t last = 0u;  // the tile placed last, 0 once it has merged
  int shift = 0;       // 8 * tiles placed
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t c = (row >> (8 * i)) & 0xFFu;
    if (c == 0u) continue;
    if (c == last) {
      out += 1u << (shift - 8);
      score += 2 << c;
      last = 0u;
    } else {
      out |= c << shift;
      shift += 8;
      last = c;
    }
  }
  return out;
}

// One tile on the rank-th empty cell in row-major order, rank = the high 32
// bits of bits0 * num_empty; a 4 where bits1 < kFourThreshold, else a 2.
__device__ __forceinline__ void spawn(Board& b, uint32_t bits0, uint32_t bits1) {
  const int num_empty = count_empty(b);
  if (num_empty == 0) return;
  int skip = (int)__umulhi(bits0, (uint32_t)num_empty);  // empty cells still to pass; negative once placed
  const uint32_t tile = bits1 < kFourThreshold ? 2u : 1u;
#pragma unroll
  for (int row = 0; row < 4; ++row) {
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const bool empty = ((b.r[row] >> (8 * col)) & 0xFFu) == 0u;
      if (empty && skip == 0) b.r[row] |= tile << (8 * col);
      skip -= empty ? 1 : 0;
    }
  }
}

__device__ __forceinline__ Board fresh_board(uint32_t game_seed) {
  Board b = {{0u, 0u, 0u, 0u}};
#pragma unroll
  for (uint32_t i = 0; i < 2; ++i) {
    uint32_t b0, b1;
    threefry2x32(kSpawnStream, game_seed, i, 0u, b0, b1);
    spawn(b, b0, b1);
  }
  return b;
}

// No empty cell and no two equal neighbours, in a row or in a column.
__device__ __forceinline__ bool is_done(const Board& b) {
  uint32_t all_differ = 0x80808080u;  // bit 7 of a byte survives while no test found a zero there
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    all_differ &= nonzero_bytes(b.r[i]);                                  // cell not empty
    all_differ &= nonzero_bytes((b.r[i] ^ (b.r[i] >> 8)) | 0x7F000000u);  // differs from its right neighbour
    if (i < 3) all_differ &= nonzero_bytes(b.r[i] ^ b.r[i + 1]);          // differs from the cell below
  }
  return all_differ == 0x80808080u;
}

__global__ void __launch_bounds__(kThreads)
random_rollout_kernel(const long long* __restrict__ seeds, int* __restrict__ boards, int* __restrict__ episodes,
                      float* __restrict__ reward_sum, int* __restrict__ max_tile, int B, int num_steps) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B) return;

  uint32_t game_seed = (uint32_t)seeds[idx];
  Board board = fresh_board(game_seed);
  uint32_t spawn_count = 2u;
  uint32_t episode = 0u;
  int finished = 0;
  float reward = 0.f;
  uint32_t max_cells = 0u;  // per-byte maximum over every board seen after a step

  for (int t = 0; t < num_steps; ++t) {
    uint32_t a0, a1;
    threefry2x32(kActionStream, game_seed, (uint32_t)t, spawn_count, a0, a1);
    const uint32_t action = a0 & 3u;

    Board slid = orient(board, action);
    int score = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) slid.r[i] = slide_row_left(slid.r[i], score);
    slid = unorient(slid, action);

    const bool moved = ((slid.r[0] ^ board.r[0]) | (slid.r[1] ^ board.r[1]) | (slid.r[2] ^ board.r[2]) |
                        (slid.r[3] ^ board.r[3])) != 0u;
    if (moved) {
      uint32_t b0, b1;
      threefry2x32(kSpawnStream, game_seed, spawn_count, 0u, b0, b1);
      spawn(slid, b0, b1);
      board = slid;
      reward += (float)score;
      spawn_count += 1u;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) max_cells = __vmaxu4(max_cells, board.r[i]);

    if (is_done(board)) {
      finished += 1;
      episode += 1u;
      uint32_t reseed, unused;
      threefry2x32(kGameSeedStream, 0u, game_seed, episode, reseed, unused);
      game_seed = reseed;
      board = fresh_board(game_seed);
      spawn_count = 2u;
    }
  }

#pragma unroll
  for (int row = 0; row < 4; ++row) {
    int4 cells;
    cells.x = (int)(board.r[row] & 0xFFu);
    cells.y = (int)((board.r[row] >> 8) & 0xFFu);
    cells.z = (int)((board.r[row] >> 16) & 0xFFu);
    cells.w = (int)(board.r[row] >> 24);
    reinterpret_cast<int4*>(boards)[(size_t)idx * 4 + row] = cells;
  }
  const int max_exp = (int)max(max(max_cells & 0xFFu, (max_cells >> 8) & 0xFFu),
                               max((max_cells >> 16) & 0xFFu, max_cells >> 24));
  episodes[idx] = finished;
  reward_sum[idx] = reward;
  max_tile[idx] = max_exp > 0 ? (1 << max_exp) : 0;
}

}  // namespace

extern "C" {

const char* random_rollout_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// seeds (B,) int64 holding uint32 values; boards (B, 4, 4) int32; episodes,
// max_tile (B,) int32; reward_sum (B,) float32. Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a bad shape.
int random_rollout_launch(const long long* seeds, int* boards, int* episodes, float* reward_sum, int* max_tile, int B,
                          int num_steps, cudaStream_t stream) {
  if (B <= 0 || num_steps < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  random_rollout_kernel<<<blocks, kThreads, 0, stream>>>(seeds, boards, episodes, reward_sum, max_tile, B, num_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
