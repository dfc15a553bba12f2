// Ring all-reduce-sum kernel for Hopper (sm_90a): N ranks, each holding a
// same-shaped float32 shard, end with the sum of all N shards, in one launch.
//
// Replaces the TPU kernel simulate_2048_tpu/parallel/ring.py (_ring_kernel /
// ring_all_reduce_shard) and computes what it computes, in its order of
// additions: rank i ends with ((x_i + x_{i-1}) + x_{i-2}) + ... + x_{i+1},
// bit for bit what parallel/ring.py's ring_all_reduce_reference computes.
//
// The ranks are virtual: every rank's input, output and two ring slots are
// separate allocations on one card, addressed through a table of pointers
// (RingArgs, in the kernel's parameters), and each rank is played by its own
// thread blocks of one cooperative launch. A "remote copy" is a store into the
// right neighbour's slot; a semaphore is a counter in global memory, raised
// with a release at system scope and polled with an acquire at system scope.
// Nothing in the kernel assumes that the pointers lie on one card: with peer
// pointers in the table the same protocol runs across cards.
//
// Channels: block c of every rank runs its own ring over chunk c of the shard
// (a multiple of 4 elements; the last chunk takes the tail), with its own
// counters, so that N * C blocks spread over the card. Each element still
// sees the same additions in the same order.
//
// Protocol per channel, as ring.py:53-84 (counters only grow; a wait is
// "until the counter reaches k"):
//   1. barrier: raise both neighbours' barrier counters, wait for ours to reach 2;
//   2. acc <- x, slot[0] <- x;
//   3. for step in 0 .. N-2 (src = step % 2, dst = 1 - src):
//        from step 1 on, wait for our ack counter to reach step (the right
//        neighbour has sent from, and added, the slot we are about to fill);
//        store slot[src] into the right neighbour's slot[dst]; raise its recv;
//        wait for our recv counter to reach step + 1;
//        unless this is the last step, raise the left neighbour's ack;
//        acc += slot[dst].
//   The last step sends no ack, as ring.py:83-84: an ack left over would
//   start the next launch off by one.
//
// Memory ordering: the writer's threads finish their stores, __syncthreads(),
// then thread 0 fences and raises the counter with red.release.sys. The
// reader's thread 0 polls with ld.acquire.sys, then __syncthreads(). Slots are
// read with ld.global.cg (L2, never a stale L1 line: a slot is refilled every
// other step).
//
// The counters live in a workspace that the wrapper owns, and the launcher
// zeroes them with cudaMemsetAsync on the launch's stream before every
// launch (no epoch counters).
//
// Every poll is bounded: after kMaxPolls polls (with __nanosleep between
// them) the kernel traps, so a protocol fault is a CUDA error in Python and
// not a hang. The launch is cooperative: it either has every one of the
// N * C blocks resident at once or fails, since a spinning block waiting on
// one that was never scheduled would deadlock silently.
//
// What bounds it: device memory. The function reads N shards and writes N
// sums; the simple ring's schedule moves (3 + 5 (N - 1)) shard sizes per
// rank (init: read x, write acc and slot 0; per step: read the send slot,
// write the neighbour's slot, read the received slot, read and write acc).
// The adds are 1 per 5 words moved. So the design keeps every load and store
// 16 bytes wide when the pointers allow it, and puts enough blocks in flight
// to saturate HBM; it spends no shared memory.
//
// Plain C interface at the bottom; loaded with ctypes (parallel/ring.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 16;
constexpr int kMaxChannels = 512;
constexpr int kCountersPerChannel = 4;  // barrier, recv, ack, padding
constexpr int kBarrier = 0, kRecv = 1, kAck = 2;
constexpr int kThreads = 512;
constexpr unsigned long long kMaxPolls = 1ull << 24;

struct RingArgs {
  const float* in[kMaxRanks];
  float* out[kMaxRanks];
  float* slot[kMaxRanks][2];
  unsigned int* counters[kMaxRanks];  // each rank's (kMaxChannels, kCountersPerChannel) block
};

// Thread 0 only, after the block's __syncthreads(): publish the block's writes, then raise *counter.
__device__ __forceinline__ void post(unsigned int* counter) {
  __threadfence_system();
  asm volatile("red.release.sys.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* counter) {
  unsigned int v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
  return v;
}

// The whole block waits until *counter >= target; thread 0 polls.
__device__ __forceinline__ void wait_for(const unsigned int* counter, unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned long long polls = 0;
    while (load_acquire(counter) < target) {
      if (++polls > kMaxPolls) __trap();
      if (polls > 32) __nanosleep(256);
    }
    __threadfence_system();
  }
  __syncthreads();
}

// acc[i] = x[i]; slot[i] = x[i] over [lo, hi).
template <bool kVec>
__device__ __forceinline__ void load_shard(const float* x, float* acc, float* slot, long long lo, long long hi) {
  long long i = lo + threadIdx.x;
  if (kVec) {
    const long long hi4 = lo + (hi - lo) / 4 * 4;
    for (long long j = lo + 4 * threadIdx.x; j < hi4; j += 4 * kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(x + j);
      *reinterpret_cast<float4*>(acc + j) = v;
      __stcg(reinterpret_cast<float4*>(slot + j), v);
    }
    i = hi4 + threadIdx.x;
  }
  for (; i < hi; i += kThreads) {
    const float v = x[i];
    acc[i] = v;
    __stcg(slot + i, v);
  }
}

// dst[i] = src[i] over [lo, hi): our send slot into the right neighbour's receive slot.
template <bool kVec>
__device__ __forceinline__ void send(const float* src, float* dst, long long lo, long long hi) {
  long long i = lo + threadIdx.x;
  if (kVec) {
    const long long hi4 = lo + (hi - lo) / 4 * 4;
    for (long long j = lo + 4 * threadIdx.x; j < hi4; j += 4 * kThreads) {
      __stcg(reinterpret_cast<float4*>(dst + j), __ldcg(reinterpret_cast<const float4*>(src + j)));
    }
    i = hi4 + threadIdx.x;
  }
  for (; i < hi; i += kThreads) __stcg(dst + i, __ldcg(src + i));
}

// acc[i] += slot[i] over [lo, hi).
template <bool kVec>
__device__ __forceinline__ void accumulate(float* acc, const float* slot, long long lo, long long hi) {
  long long i = lo + threadIdx.x;
  if (kVec) {
    const long long hi4 = lo + (hi - lo) / 4 * 4;
    for (long long j = lo + 4 * threadIdx.x; j < hi4; j += 4 * kThreads) {
      float4 a = *reinterpret_cast<float4*>(acc + j);
      const float4 b = __ldcg(reinterpret_cast<const float4*>(slot + j));
      a.x = __fadd_rn(a.x, b.x);
      a.y = __fadd_rn(a.y, b.y);
      a.z = __fadd_rn(a.z, b.z);
      a.w = __fadd_rn(a.w, b.w);
      *reinterpret_cast<float4*>(acc + j) = a;
    }
    i = hi4 + threadIdx.x;
  }
  for (; i < hi; i += kThreads) acc[i] = __fadd_rn(acc[i], __ldcg(slot + i));
}

// Block b plays channel b % channels of rank b / channels.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) ring_kernel(RingArgs a, int ranks, int channels, long long n,
                                                        long long per_channel) {
  const int rank = blockIdx.x / channels;
  const int channel = blockIdx.x % channels;
  const int right = rank + 1 == ranks ? 0 : rank + 1;
  const int left = rank == 0 ? ranks - 1 : rank - 1;
  const long long lo = min(n, channel * per_channel);
  const long long hi = min(n, lo + per_channel);
  unsigned int* mine = a.counters[rank] + channel * kCountersPerChannel;
  unsigned int* of_right = a.counters[right] + channel * kCountersPerChannel;
  unsigned int* of_left = a.counters[left] + channel * kCountersPerChannel;

  // 1. Both neighbours have started before anyone stores into their slots.
  if (threadIdx.x == 0) {
    post(of_left + kBarrier);
    post(of_right + kBarrier);
  }
  wait_for(mine + kBarrier, 2);

  // 2. acc <- x, slot[0] <- x.
  float* acc = a.out[rank];
  load_shard<kVec>(a.in[rank], acc, a.slot[rank][0], lo, hi);

  // 3. N - 1 hops to the right.
  for (int step = 0; step < ranks - 1; ++step) {
    const int src = step & 1, dst = src ^ 1;
    if (step >= 1) wait_for(mine + kAck, step);
    send<kVec>(a.slot[rank][src], a.slot[right][dst], lo, hi);
    __syncthreads();
    if (threadIdx.x == 0) post(of_right + kRecv);
    wait_for(mine + kRecv, step + 1);
    if (step < ranks - 2 && threadIdx.x == 0) post(of_left + kAck);
    accumulate<kVec>(acc, a.slot[rank][dst], lo, hi);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

const char* ring_all_reduce_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int ring_all_reduce_max_ranks() { return kMaxRanks; }

// Bytes of the counter workspace for `ranks` ranks.
long long ring_all_reduce_counter_bytes(int ranks) {
  return static_cast<long long>(ranks) * kMaxChannels * kCountersPerChannel * sizeof(unsigned int);
}

// One cooperative launch on `stream` (and the counters' memset before it).
// inputs / outputs: `ranks` pointers to n float32 each; slots: 2 * ranks
// buffers of n float32, slot s of rank r at slots + (2 r + s) * slot_stride;
// counters: ring_all_reduce_counter_bytes(ranks) bytes. Writes the channel
// count used to *channels_out. Returns a cudaError_t (0 on success).
int ring_all_reduce_launch(const void* const* inputs, void* const* outputs, void* slots, long long slot_stride,
                           void* counters, int ranks, long long n, void* stream, int* channels_out) {
  if (ranks < 2 || ranks > kMaxRanks || n < 0 || slot_stride < n) return static_cast<int>(cudaErrorInvalidValue);
  RingArgs a;
  bool vec = aligned16(slots) && slot_stride % 4 == 0;
  for (int r = 0; r < ranks; ++r) {
    a.in[r] = static_cast<const float*>(inputs[r]);
    a.out[r] = static_cast<float*>(outputs[r]);
    a.slot[r][0] = static_cast<float*>(slots) + (2LL * r) * slot_stride;
    a.slot[r][1] = static_cast<float*>(slots) + (2LL * r + 1) * slot_stride;
    a.counters[r] = static_cast<unsigned int*>(counters) + static_cast<long long>(r) * kMaxChannels * kCountersPerChannel;
    vec = vec && aligned16(inputs[r]) && aligned16(outputs[r]);
  }
  int device = 0, sms = 0, cooperative = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cooperative) return static_cast<int>(cudaErrorNotSupported);
  const void* fn = vec ? (const void*)ring_kernel<true> : (const void*)ring_kernel<false>;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // As many channels as can be resident together, and no more than the shard has 4 * kThreads elements.
  long long channels = static_cast<long long>(per_sm) * sms / ranks;
  channels = channels < kMaxChannels ? channels : kMaxChannels;
  const long long wanted = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  channels = channels < wanted ? channels : wanted;
  channels = channels > 1 ? channels : 1;
  int c = static_cast<int>(channels);
  long long per_channel = ((n + c - 1) / c + 3) / 4 * 4;
  *channels_out = c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counters, 0, ring_all_reduce_counter_bytes(ranks), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a, &ranks, &c, &n, &per_channel};
  err = cudaLaunchCooperativeKernel(fn, dim3(ranks * c), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
