// All-reduce-sum kernel for Hopper (sm_90a), in one pass: N ranks, each
// holding a same-shaped float32, bfloat16 or float16 shard, end with the sum
// of all N shards, in one launch.
//
// Replaces the TPU kernel simulate_2048_tpu/parallel/ring.py (_ring_kernel /
// ring_all_reduce_shard) and computes what it computes, in its order of
// additions: rank i ends with ((x_i + x_{i-1}) + x_{i-2}) + ... + x_{i+1},
// bit for bit what parallel/ring.py's ring_all_reduce_reference computes.
//
// What bounds it: device memory. The function must read N shards and write
// N sums, 2 N m sizeof(T) bytes; its adds, N (N - 1) per element, are a few
// microseconds at the FP32 rate. There is no reuse to stage in shared memory.
// What the card needs is enough bytes in flight: by Little's law about
// 3.35 TB/s x 0.8 us = 2.7 MB, some 20 KB per SM.
//
// The design: one pass, with element ranges, not ranks, owning the work.
//   - A launch takes the N input pointers, the N output pointers and an
//     element range [lo, hi); on one card the range is the whole shard.
//   - A grid-stride loop gives each thread whole 16-byte vectors of the
//     range (4 floats, or 8 bf16 / fp16 values). For each vector the thread
//     loads the N ranks' values into registers, forms every rank's sum in
//     that rank's rotation order, acc = v[i], then acc = add(acc,
//     v[(i - 1 - s) mod N]) for s = 0 .. N-2, and stores the N sums. So every
//     byte is read once and written once: the bound's bytes, no more.
//   - N and the element type are template parameters, so v[] and the
//     rotation indices are compile-time and v[] stays in registers.
//   - add is __fadd_rn in float32. In bf16 and fp16 it is the float sum
//     rounded to the type after every add, which is what the plain version
//     and the TPU kernel's `o_ref[...] += comm[dst]` compute. The vector
//     loop does it with the packed bf16x2 / f16x2 add, which gives the same
//     bits: a float32 sum of two values of p-bit significands, rounded to p
//     bits, is the correctly rounded sum whenever 24 >= 2p + 2 (p = 8 for
//     bf16, 11 for fp16), and the packed add is correctly rounded.
//   - The inputs are read once, so they are loaded with __ldcs (evict
//     first); the sums take plain stores, since the caller reads them next.
//   - The grid is one wave: SMs x the blocks an SM holds, capped by the
//     vectors there are.
//   - Views that are not 16-byte aligned, and the tail of fewer than one
//     vector, take a scalar loop with the same order of additions.
//   - No block waits on another: there is no protocol inside a launch.
//
// Across cards the same body would run on each card over its 1/N of the
// elements, through peer pointers, between an entry and an exit barrier;
// that is not built here (the wrapper takes the ranks of one card).
//
// Two vectors per rank per loop iteration, ld.global.nc.L1::no_allocate or
// plain loads, __stcs stores and a float add rounded per add were measured
// beside this design on an NVIDIA H100 80GB HBM3 at 700.00 W and were no
// faster (PERF.md).
//
// Plain C interface at the bottom; loaded with ctypes (parallel/ring.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxRanks = 16;
constexpr int kThreads = 256;

struct Ptrs {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
};

// ---- one element: the scalar loop (tail, unaligned views)

__device__ __forceinline__ float add1(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ __nv_bfloat16 add1(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

__device__ __forceinline__ __half add1(__half a, __half b) {
  return __float2half_rn(__fadd_rn(__half2float(a), __half2float(b)));
}

// ---- 16 bytes: the vector loop

template <typename P>
__device__ __forceinline__ P as(uint32_t w) {
  P p;
  memcpy(&p, &w, sizeof(w));
  return p;
}

template <typename P>
__device__ __forceinline__ uint32_t word(P p) {
  uint32_t w;
  memcpy(&w, &p, sizeof(w));
  return w;
}

// One 32-bit word: one float, or two bf16 / fp16 values.
template <typename T>
__device__ __forceinline__ uint32_t add_word(uint32_t a, uint32_t b);

template <>
__device__ __forceinline__ uint32_t add_word<float>(uint32_t a, uint32_t b) {
  return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
}

template <>
__device__ __forceinline__ uint32_t add_word<__nv_bfloat16>(uint32_t a, uint32_t b) {
  return word(__hadd2(as<__nv_bfloat162>(a), as<__nv_bfloat162>(b)));
}

template <>
__device__ __forceinline__ uint32_t add_word<__half>(uint32_t a, uint32_t b) {
  return word(__hadd2(as<__half2>(a), as<__half2>(b)));
}

template <typename T>
__device__ __forceinline__ uint4 add16(uint4 a, uint4 b) {
  return make_uint4(add_word<T>(a.x, b.x), add_word<T>(a.y, b.y), add_word<T>(a.z, b.z), add_word<T>(a.w, b.w));
}

// Every rank's sum over [lo, hi), in its rotation order. With `vec` the
// 2 N pointers plus lo are 16-byte aligned and whole vectors take the vector
// loop; the rest takes the scalar loop.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1) all_reduce_kernel(Ptrs p, long long lo, long long hi, int vec) {
  constexpr int kPer = 16 / sizeof(T);
  const long long thread = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  long long tail = lo;
  if (vec) {
    const long long nvec = (hi - lo) / kPer;
    for (long long k = thread; k < nvec; k += threads) {
      uint4 v[N];
#pragma unroll
      for (int r = 0; r < N; ++r) {
        v[r] = __ldcs(reinterpret_cast<const uint4*>(static_cast<const T*>(p.in[r]) + lo) + k);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        uint4 acc = v[i];
#pragma unroll
        for (int s = 0; s < N - 1; ++s) acc = add16<T>(acc, v[(i + 2 * N - 1 - s) % N]);
        reinterpret_cast<uint4*>(static_cast<T*>(p.out[i]) + lo)[k] = acc;
      }
    }
    tail = lo + nvec * kPer;
  }
  for (long long e = tail + thread; e < hi; e += threads) {
    T x[N];
#pragma unroll
    for (int r = 0; r < N; ++r) x[r] = static_cast<const T*>(p.in[r])[e];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T acc = x[i];
#pragma unroll
      for (int s = 0; s < N - 1; ++s) acc = add1(acc, x[(i + 2 * N - 1 - s) % N]);
      static_cast<T*>(p.out[i])[e] = acc;
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename T, int N>
cudaError_t launch(const Ptrs& p, long long lo, long long hi, cudaStream_t stream, int* blocks_out,
                   long long* vectors_per_thread_out) {
  constexpr long long kPer = 16 / sizeof(T);
  bool vec = (lo * static_cast<long long>(sizeof(T))) % 16 == 0;
  for (int r = 0; r < N; ++r) vec = vec && aligned16(p.in[r]) && aligned16(p.out[r]);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, all_reduce_kernel<T, N>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  // Work items: whole vectors on the vector path (the tail's few scalars ride along), scalars otherwise.
  const long long items = vec ? (hi - lo) / kPer : hi - lo;
  const long long wanted = (items + kThreads - 1) / kThreads;
  long long blocks = static_cast<long long>(sms) * per_sm;
  blocks = blocks < wanted ? blocks : wanted;
  blocks = blocks > 1 ? blocks : 1;
  *blocks_out = static_cast<int>(blocks);
  *vectors_per_thread_out = vec ? (items + blocks * kThreads - 1) / (blocks * kThreads) : 0;
  all_reduce_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p, lo, hi, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int ranks, const Ptrs& p, long long lo, long long hi, cudaStream_t stream, int* blocks_out,
                     long long* vectors_per_thread_out) {
  switch (ranks) {
#define RING_CASE(n) \
  case n:            \
    return launch<T, n>(p, lo, hi, stream, blocks_out, vectors_per_thread_out);
    RING_CASE(2) RING_CASE(3) RING_CASE(4) RING_CASE(5) RING_CASE(6) RING_CASE(7) RING_CASE(8) RING_CASE(9)
    RING_CASE(10) RING_CASE(11) RING_CASE(12) RING_CASE(13) RING_CASE(14) RING_CASE(15) RING_CASE(16)
#undef RING_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* ring_all_reduce_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int ring_all_reduce_max_ranks() { return kMaxRanks; }

// One launch on `stream` over the element range [lo, hi) of every shard.
// inputs / outputs: `ranks` pointers each; dtype: 0 float32, 1 bfloat16,
// 2 float16. Writes the grid's blocks and the 16-byte vectors per rank each
// thread handles (0 on the scalar path) to the two out-pointers; launches
// nothing for an empty range. Returns a cudaError_t (0 on success).
int ring_all_reduce_launch(const void* const* inputs, void* const* outputs, int ranks, int dtype, long long lo,
                           long long hi, void* stream, int* blocks_out, long long* vectors_per_thread_out) {
  *blocks_out = 0;
  *vectors_per_thread_out = 0;
  if (ranks < 2 || ranks > kMaxRanks || lo < 0 || hi < lo) return static_cast<int>(cudaErrorInvalidValue);
  if (hi == lo) return 0;
  Ptrs p;
  for (int r = 0; r < ranks; ++r) {
    p.in[r] = inputs[r];
    p.out[r] = outputs[r];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch<float>(ranks, p, lo, hi, s, blocks_out, vectors_per_thread_out));
    case 1:
      return static_cast<int>(dispatch<__nv_bfloat16>(ranks, p, lo, hi, s, blocks_out, vectors_per_thread_out));
    case 2:
      return static_cast<int>(dispatch<__half>(ranks, p, lo, hi, s, blocks_out, vectors_per_thread_out));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
