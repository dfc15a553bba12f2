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
// What bounds it: 32-bit integer instructions. A board reads 8 bytes (its
// seed; none when the launch derives the seeds) and writes 76 whatever the
// number of steps, while every step costs a Threefry-2x32 of 20 rounds for the
// action and, when the board moved, another for the spawn. Everything else a
// step does is cut to a few dozen instructions:
// - one thread per board, any batch size (the last block is masked);
// - the board is 16 cells of 4 bits in two words (cell (r, c) at bit
//   4(4r + c) of lo:hi), so that a row is 16 bits;
// - a move is four independent reads of a table of slid rows (ops/
//   rollout_kernel.py slide_table, built by the port's own board ops and
//   read through L1): left and right have a table each, up and down read
//   them on the transposed board (two byte permutes and two nibble swaps),
//   selected without a branch so that the threads of a warp stay together
//   whatever directions their boards drew. An entry holds the slid row, a
//   quarter of its score and a flag: the slid row holds a 15;
// - the spawn takes the empty cells as a mask (a zero-nibble test), their
//   prefix counts by one multiply, and the rank-th of them by a zero-nibble
//   test on the counts: no walk over the cells;
// - only a move can end a game, and only a board with at most one empty
//   cell left can be finished: the neighbour test runs only there;
// - the largest tile is taken where an episode ends and at the end, since
//   tiles never shrink within an episode.
// A 15 cannot be slid by a 4-bit table (two 15s make 16), so a board that
// reaches 15 is carried exactly for the rest of its episode as four words of
// byte cells, slid and spawned cell by cell. Random play rarely gets there;
// board_ops_kernel below lets a check reach that path.
//
// With no seeds given, thread i derives its board's seed from the run seed,
// derive_game_seeds(run_seed, i, 0) of ops/rng.py, inside the launch.
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
constexpr uint32_t kTableRows = 1u << 16;  // entries a direction

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

// ---- The board of 4-bit cells: lo holds rows 0 and 1, hi rows 2 and 3.

struct Nibbles {
  uint32_t lo, hi;
};

// The transposed board. Swapping the 2x2 blocks off the diagonal moves bytes
// (one byte is two cells of a row); swapping the two cells off the diagonal of
// each 2x2 block moves nibbles 12 bits apart.
__device__ __forceinline__ Nibbles transpose(Nibbles b) {
  uint32_t x = __byte_perm(b.lo, b.hi, 0x6240);
  uint32_t y = __byte_perm(b.lo, b.hi, 0x7351);
  uint32_t t = (x ^ (x >> 12)) & 0x0000F0F0u;
  x ^= t ^ (t << 12);
  t = (y ^ (y >> 12)) & 0x0000F0F0u;
  y ^= t ^ (t << 12);
  return {x, y};
}

// A move read from the table, on the board oriented so that it is a slide of
// rows: in and out are the oriented board before and after, e the four rows'
// entries.
struct Slide {
  Nibbles in, out;
  uint32_t e[4];
};

// Actions 0 left, 1 up, 2 right, 3 down: bit 0 transposes, bit 1 takes the
// right table. table holds the left table's kTableRows entries, then the right's.
__device__ __forceinline__ Slide slide(Nibbles b, uint32_t action, const uint32_t* __restrict__ table) {
  const Nibbles t = transpose(b);
  const bool vertical = (action & 1u) != 0u;
  Slide s;
  s.in.lo = vertical ? t.lo : b.lo;
  s.in.hi = vertical ? t.hi : b.hi;
  const uint32_t* tab = table + ((action & 2u) ? kTableRows : 0u);
  s.e[0] = __ldg(tab + (s.in.lo & 0xFFFFu));
  s.e[1] = __ldg(tab + (s.in.lo >> 16));
  s.e[2] = __ldg(tab + (s.in.hi & 0xFFFFu));
  s.e[3] = __ldg(tab + (s.in.hi >> 16));
  s.out.lo = __byte_perm(s.e[0], s.e[1], 0x5410);
  s.out.hi = __byte_perm(s.e[2], s.e[3], 0x5410);
  return s;
}

__device__ __forceinline__ bool moved(const Slide& s) {
  return ((s.out.lo ^ s.in.lo) | (s.out.hi ^ s.in.hi)) != 0u;
}

// The slid board in the board's own orientation, the move's score, and
// whether a cell of the slid board is 15 (the board leaves the table then).
__device__ __forceinline__ Nibbles settle(const Slide& s, uint32_t action, uint32_t& score, bool& reaches_15) {
  const Nibbles t = transpose(s.out);
  const bool vertical = (action & 1u) != 0u;
  const uint32_t s01 = __byte_perm(s.e[0], s.e[1], 0x7632);  // the entries' upper halves, two to a word
  const uint32_t s23 = __byte_perm(s.e[2], s.e[3], 0x7632);
  reaches_15 = ((s01 | s23) & 0x80008000u) != 0u;
  const uint32_t q = (s01 & 0x7FFF7FFFu) + (s23 & 0x7FFF7FFFu);  // each half below 2^16: a row's quarter score is at most 2^14
  score = ((q & 0xFFFFu) + (q >> 16)) << 2;
  return {vertical ? t.lo : s.out.lo, vertical ? t.hi : s.out.hi};
}

// Bit 4k set where nibble k of w is 0.
__device__ __forceinline__ uint32_t zero_nibbles(uint32_t w) {
  w |= w >> 1;
  w |= w >> 2;
  return ~w & 0x11111111u;
}

// One tile on the rank-th empty cell in row-major order, rank = the high 32
// bits of bits0 * num_empty; a 4 where bits1 < kFourThreshold, else a 2. A
// full board is left as it is. Returns the number of empty cells before.
__device__ __forceinline__ uint32_t spawn(Nibbles& b, uint32_t bits0, uint32_t bits1) {
  const uint32_t plo = zero_nibbles(b.lo) * 0x11111111u;  // nibble k: empty cells among cells 0..k of the word
  const uint32_t phi = zero_nibbles(b.hi) * 0x11111111u;
  const uint32_t nlo = plo >> 28;
  const uint32_t n = nlo + (phi >> 28);
  const uint32_t rank = __umulhi(bits0, n);
  const bool upper = rank >= nlo;
  // The target is the first cell of its word whose prefix count is want: the
  // lowest zero nibble of p ^ want, exact for the lowest one.
  const uint32_t want = (upper ? rank - nlo : rank) + 1u;
  const uint32_t x = (upper ? phi : plo) ^ (want * 0x11111111u);
  const uint32_t z = (x - 0x11111111u) & ~x & 0x88888888u;
  const uint32_t tile = ((z & (0u - z)) >> 3) << (bits1 < kFourThreshold ? 1 : 0);
  b.lo |= upper ? 0u : tile;
  b.hi |= upper ? tile : 0u;
  return n;
}

// Nonzero iff v has a zero nibble (its lowest set bit marks the lowest one).
__device__ __forceinline__ uint32_t has_zero_nibble(uint32_t v) { return (v - 0x11111111u) & ~v & 0x88888888u; }

// Finished: no empty cell and no two equal neighbours. num_empty is the count
// before the spawn that made b; with two or more an empty cell remains.
__device__ __forceinline__ bool finished(Nibbles b, uint32_t num_empty) {
  if (num_empty > 1u) return false;
  const uint32_t h_lo = (b.lo ^ (b.lo >> 4)) | 0xF000F000u;  // nibble 4r+c: cell c ^ cell c+1; the last column masked
  const uint32_t h_hi = (b.hi ^ (b.hi >> 4)) | 0xF000F000u;
  const uint32_t v01_12 = __byte_perm(b.lo ^ (b.lo >> 16), (b.lo >> 16) ^ b.hi, 0x5410);  // rows 0^1 and 1^2
  const uint32_t v23 = (b.hi ^ (b.hi >> 16)) | 0xFFFF0000u;                               // rows 2^3
  return (has_zero_nibble(h_lo) | has_zero_nibble(h_hi) | has_zero_nibble(v01_12) | has_zero_nibble(v23)) == 0u;
}

__device__ __forceinline__ uint32_t max_cell(Nibbles b) {
  uint32_t m = __vmaxu4(__vmaxu4(b.lo & 0x0F0F0F0Fu, (b.lo >> 4) & 0x0F0F0F0Fu),
                        __vmaxu4(b.hi & 0x0F0F0F0Fu, (b.hi >> 4) & 0x0F0F0F0Fu));
  m = __vmaxu4(m, m >> 16);
  m = __vmaxu4(m, m >> 8);
  return m & 0xFFu;
}

__device__ __forceinline__ Nibbles fresh_board(uint32_t game_seed) {
  Nibbles b = {0u, 0u};
#pragma unroll
  for (uint32_t i = 0; i < 2; ++i) {
    uint32_t b0, b1;
    threefry2x32(kSpawnStream, game_seed, i, 0u, b0, b1);
    spawn(b, b0, b1);
  }
  return b;
}

// ---- The exact path: byte cells, one row a word (exponents below 128).

struct Bytes {
  uint32_t r[4];  // row-major: cell (row, col) is byte col of r[row]
};

__device__ __forceinline__ Bytes widen(Nibbles b) {
  Bytes w;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t row = ((i < 2 ? b.lo : b.hi) >> (16 * (i & 1))) & 0xFFFFu;
    w.r[i] = (row & 0xFu) | ((row & 0xF0u) << 4) | ((row & 0xF00u) << 8) | ((row & 0xF000u) << 12);
  }
  return w;
}

// Bit 7 of every byte of v that is not zero (bytes must be below 0x80).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) { return (v + 0x7F7F7F7Fu) & 0x80808080u; }

__device__ __forceinline__ Bytes transpose(const Bytes& b) {
  const uint32_t lo01 = __byte_perm(b.r[0], b.r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t hi01 = __byte_perm(b.r[0], b.r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t lo23 = __byte_perm(b.r[2], b.r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(b.r[2], b.r[3], 0x7362);
  Bytes t;
  t.r[0] = __byte_perm(lo01, lo23, 0x5410);
  t.r[1] = __byte_perm(lo01, lo23, 0x7632);
  t.r[2] = __byte_perm(hi01, hi23, 0x5410);
  t.r[3] = __byte_perm(hi01, hi23, 0x7632);
  return t;
}

// Left for action 0, up for 1, right for 2, down for 3 become "left" on the
// oriented board: bit 0 transposes, then bit 1 mirrors every row.
__device__ __forceinline__ Bytes orient(const Bytes& b, uint32_t action) {
  const Bytes t = transpose(b);
  Bytes o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t row = (action & 1u) ? t.r[i] : b.r[i];
    o.r[i] = (action & 2u) ? __byte_perm(row, 0u, 0x0123) : row;
  }
  return o;
}

__device__ __forceinline__ Bytes unorient(const Bytes& o, uint32_t action) {
  Bytes m;
#pragma unroll
  for (int i = 0; i < 4; ++i) m.r[i] = (action & 2u) ? __byte_perm(o.r[i], 0u, 0x0123) : o.r[i];
  const Bytes t = transpose(m);
  Bytes b;
#pragma unroll
  for (int i = 0; i < 4; ++i) b.r[i] = (action & 1u) ? t.r[i] : m.r[i];
  return b;
}

// Slide one row towards byte 0: tiles keep their order, equal neighbours merge
// once, left to right; a merge of two 2^e tiles scores 2^(e+1) = 2 << e.
__device__ __forceinline__ uint32_t slide_row_left(uint32_t row, uint32_t& score) {
  uint32_t out = 0u;
  uint32_t last = 0u;  // the tile placed last, 0 once it has merged
  int shift = 0;       // 8 * tiles placed
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t c = (row >> (8 * i)) & 0xFFu;
    if (c == 0u) continue;
    if (c == last) {
      out += 1u << (shift - 8);
      score += 2u << c;
      last = 0u;
    } else {
      out |= c << shift;
      shift += 8;
      last = c;
    }
  }
  return out;
}

__device__ __forceinline__ Bytes slide_bytes(const Bytes& b, uint32_t action, uint32_t& score) {
  Bytes s = orient(b, action);
  score = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) s.r[i] = slide_row_left(s.r[i], score);
  return unorient(s, action);
}

// The spawn of spawn(Nibbles&, ...) on byte cells, by a walk over the 16 cells.
__device__ __forceinline__ void spawn(Bytes& b, uint32_t bits0, uint32_t bits1) {
  const int num_empty = 16 - __popc(nonzero_bytes(b.r[0])) - __popc(nonzero_bytes(b.r[1])) -
                        __popc(nonzero_bytes(b.r[2])) - __popc(nonzero_bytes(b.r[3]));
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

__device__ __forceinline__ bool finished(const Bytes& b) {
  uint32_t all_differ = 0x80808080u;  // bit 7 of a byte survives while no test found a zero there
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    all_differ &= nonzero_bytes(b.r[i]);                                  // cell not empty
    all_differ &= nonzero_bytes((b.r[i] ^ (b.r[i] >> 8)) | 0x7F000000u);  // differs from its right neighbour
    if (i < 3) all_differ &= nonzero_bytes(b.r[i] ^ b.r[i + 1]);          // differs from the cell below
  }
  return all_differ == 0x80808080u;
}

__device__ __forceinline__ uint32_t max_cell(const Bytes& b) {
  const uint32_t m = __vmaxu4(__vmaxu4(b.r[0], b.r[1]), __vmaxu4(b.r[2], b.r[3]));
  return max(max(m & 0xFFu, (m >> 8) & 0xFFu), max((m >> 16) & 0xFFu, m >> 24));
}

__device__ __forceinline__ uint32_t cell(const Nibbles& b, int k) { return ((k < 8 ? b.lo : b.hi) >> (4 * (k & 7))) & 0xFu; }
__device__ __forceinline__ uint32_t cell(const Bytes& b, int k) { return (b.r[k >> 2] >> (8 * (k & 3))) & 0xFFu; }

template <typename Board>
__device__ __forceinline__ void store(const Board& b, int* __restrict__ out) {
#pragma unroll
  for (int row = 0; row < 4; ++row) {
    const int4 cells = {(int)cell(b, 4 * row), (int)cell(b, 4 * row + 1), (int)cell(b, 4 * row + 2),
                        (int)cell(b, 4 * row + 3)};
    reinterpret_cast<int4*>(out)[row] = cells;
  }
}

__global__ void __launch_bounds__(kThreads)
random_rollout_kernel(const long long* __restrict__ seeds, uint32_t run_seed, const uint32_t* __restrict__ table,
                      int* __restrict__ boards, int* __restrict__ episodes, float* __restrict__ reward_sum,
                      int* __restrict__ max_tile, int B, int num_steps) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B) return;

  uint32_t game_seed, unused;
  if (seeds != nullptr) {
    game_seed = (uint32_t)seeds[idx];
  } else {
    threefry2x32(kGameSeedStream, run_seed, (uint32_t)idx, 0u, game_seed, unused);
  }
  Nibbles board = fresh_board(game_seed);
  Bytes wide = {{0u, 0u, 0u, 0u}};  // the board while `exact`
  bool exact = false;               // a cell has reached 15 in this episode
  uint32_t spawn_count = 2u;
  uint32_t episode = 0u;
  int finished_games = 0;
  int last_reset = -1;  // the step of the last reset
  float reward = 0.f;
  uint32_t max_exp = 0u;  // the largest cell of the boards that ended

  for (int t = 0; t < num_steps; ++t) {
    uint32_t a0, a1;
    threefry2x32(kActionStream, game_seed, (uint32_t)t, spawn_count, a0, a1);
    const uint32_t action = a0 & 3u;

    bool done = false;
    if (!exact) {
      const Slide s = slide(board, action, table);
      if (moved(s)) {
        uint32_t b0, b1, score;
        bool reaches_15;
        threefry2x32(kSpawnStream, game_seed, spawn_count, 0u, b0, b1);
        board = settle(s, action, score, reaches_15);
        const uint32_t num_empty = spawn(board, b0, b1);
        reward += (float)score;
        spawn_count += 1u;
        done = finished(board, num_empty);
        if (!done && reaches_15) {
          wide = widen(board);
          exact = true;
        }
      }
    } else {
      uint32_t score;
      const Bytes slid = slide_bytes(wide, action, score);
      const bool changed = ((slid.r[0] ^ wide.r[0]) | (slid.r[1] ^ wide.r[1]) | (slid.r[2] ^ wide.r[2]) |
                            (slid.r[3] ^ wide.r[3])) != 0u;
      if (changed) {
        uint32_t b0, b1;
        threefry2x32(kSpawnStream, game_seed, spawn_count, 0u, b0, b1);
        wide = slid;
        spawn(wide, b0, b1);
        reward += (float)score;
        spawn_count += 1u;
        done = finished(wide);
      }
    }

    if (done) {
      max_exp = max(max_exp, exact ? max_cell(wide) : max_cell(board));
      finished_games += 1;
      episode += 1u;
      uint32_t reseed;
      threefry2x32(kGameSeedStream, 0u, game_seed, episode, reseed, unused);
      game_seed = reseed;
      board = fresh_board(game_seed);
      exact = false;
      spawn_count = 2u;
      last_reset = t;
    }
  }

  // Tiles never shrink within an episode: the board's own largest cell is the
  // largest it has had, unless no step has seen this board yet.
  if (num_steps > 0 && last_reset != num_steps - 1) max_exp = max(max_exp, exact ? max_cell(wide) : max_cell(board));
  if (exact) {
    store(wide, boards + (size_t)idx * 16);
  } else {
    store(board, boards + (size_t)idx * 16);
  }
  episodes[idx] = finished_games;
  reward_sum[idx] = reward;
  max_tile[idx] = max_exp > 0u ? (1 << max_exp) : 0;
}

// The rollout kernel's own move, spawn and end test on given boards, as one
// step applies them: on the 4-bit board while every cell is below 15, else on
// the exact path. Writes the slid board and its score (the move alone), the
// board after the spawn, whether that board is finished, and whether the
// rollout would carry it on the exact path from there.
__global__ void __launch_bounds__(kThreads)
board_ops_kernel(const int* __restrict__ boards, const int* __restrict__ actions, const long long* __restrict__ bits0,
                 const long long* __restrict__ bits1, const uint32_t* __restrict__ table, int* __restrict__ slid_out,
                 int* __restrict__ score_out, int* __restrict__ spawned_out, int* __restrict__ done_out,
                 int* __restrict__ exact_out, int N) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= N) return;
  const int* in = boards + (size_t)idx * 16;
  const uint32_t action = (uint32_t)actions[idx] & 3u;
  const uint32_t b0 = (uint32_t)bits0[idx], b1 = (uint32_t)bits1[idx];
  uint32_t top = 0u;
  for (int k = 0; k < 16; ++k) top = max(top, (uint32_t)in[k]);
  uint32_t score;
  bool done, exact;
  if (top < 15u) {
    Nibbles b = {0u, 0u};
    for (int k = 0; k < 16; ++k) (k < 8 ? b.lo : b.hi) |= (uint32_t)in[k] << (4 * (k & 7));
    const Slide s = slide(b, action, table);
    bool reaches_15;
    b = settle(s, action, score, reaches_15);
    store(b, slid_out + (size_t)idx * 16);
    const uint32_t num_empty = spawn(b, b0, b1);
    done = finished(b, num_empty);
    exact = reaches_15;
    if (exact) {
      store(widen(b), spawned_out + (size_t)idx * 16);  // as the rollout carries it from here
    } else {
      store(b, spawned_out + (size_t)idx * 16);
    }
  } else {
    Bytes b;
    for (int r = 0; r < 4; ++r) {
      b.r[r] = 0u;
      for (int c = 0; c < 4; ++c) b.r[r] |= (uint32_t)in[4 * r + c] << (8 * c);
    }
    b = slide_bytes(b, action, score);
    store(b, slid_out + (size_t)idx * 16);
    spawn(b, b0, b1);
    store(b, spawned_out + (size_t)idx * 16);
    done = finished(b);
    exact = true;
  }
  score_out[idx] = (int)score;
  done_out[idx] = done ? 1 : 0;
  exact_out[idx] = exact ? 1 : 0;
}

}  // namespace

extern "C" {

const char* random_rollout_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// seeds (B,) int64 holding uint32 values, or NULL: then board i's seed is
// derive_game_seeds(run_seed, i, 0), derived in the launch. table: the
// 2 x 65,536 uint32 entries of slide_table. boards (B, 4, 4) int32; episodes,
// max_tile (B,) int32; reward_sum (B,) float32. Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a bad shape.
int random_rollout_launch(const long long* seeds, unsigned int run_seed, const unsigned int* table, int* boards,
                          int* episodes, float* reward_sum, int* max_tile, int B, int num_steps, cudaStream_t stream) {
  if (B <= 0 || num_steps < 0 || table == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  random_rollout_kernel<<<blocks, kThreads, 0, stream>>>(seeds, run_seed, table, boards, episodes, reward_sum, max_tile,
                                                         B, num_steps);
  return (int)cudaGetLastError();
}

// boards (N, 4, 4) int32 exponents (below 128); actions (N,) int32; bits0,
// bits1 (N,) int64 holding uint32 spawn bits; table as above. Writes slid and
// spawned (N, 4, 4), score, done and exact (N,) int32.
int random_rollout_board_ops_launch(const int* boards, const int* actions, const long long* bits0,
                                    const long long* bits1, const unsigned int* table, int* slid, int* score,
                                    int* spawned, int* done, int* exact, int N, cudaStream_t stream) {
  if (N <= 0 || table == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kThreads - 1) / kThreads;
  board_ops_kernel<<<blocks, kThreads, 0, stream>>>(boards, actions, bits0, bits1, table, slid, score, spawned, done,
                                                    exact, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
