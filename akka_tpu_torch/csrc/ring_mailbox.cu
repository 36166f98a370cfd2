// Ring mailbox for Hopper (sm_90a): per-recipient delivery of one step's
// messages, bound through a plain C interface (ops/cuda_mailbox.py, ctypes).
//
// Replaces the Pallas kernel of akka_tpu/ops/pallas_mailbox.py
// (`_ring_kernel`, launched by `_run`) in its two modes:
//   ring_reduce  <- _run(with_slots=False), entry deliver_reduce  (K1)
//   ring_slots   <- _run(with_slots=True),  entry deliver_slots_ring (K2)
//
// What changes from the TPU. The Pallas kernel walks the message stream in
// arrival order because a TPU grid runs in order: a per-recipient cursor in
// the revisited output block IS the FIFO. CUDA blocks run in no order, so
// arrival order comes from integer atomics whose result does not depend on
// the order they land in:
//   ring_count_sum  one thread per message row; a valid row (valid and
//                   0 <= dst < n; others are skipped, not clipped) adds 1 to
//                   counts[dst] and its payload to sums[dst, :]. Counts are
//                   exact; float sums land in a run-dependent order.
//   ring_claim      pass k of S: a valid row j with j > first[k-1][dst]
//                   takes atomicMin(&first[k][dst], j) (first[-1] = -1,
//                   first[k] starts at INT_MAX). first[k][r] is then the
//                   k-th arrival for recipient r, deterministically.
//   ring_gather     one thread per (recipient, slot): copies type, payload
//                   and valid of first[k][r] into the ring (zeros when
//                   empty) and adds max(count - S, 0) into dropped.
//
// Bound: memory bytes. Each row is read once per pass and each output
// written once; the work per byte is one add. The design keeps every pass a
// single coalesced sweep over rows or ring cells, with fire-and-forget
// atomics (RED) into the recipient arrays, which the 50 MB L2 absorbs. Hot
// recipients (fan-in collectors) serialise their atomics; warp-aggregated
// atomics and a per-block rank plus scan for large S are later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool accepted(const int* dst, const uint8_t* valid,
                                         int64_t j, int n, int* d) {
  *d = dst[j];
  return valid[j] != 0 && *d >= 0 && *d < n;
}

__global__ void ring_count_sum(const int* __restrict__ dst,
                               const float* __restrict__ payload,
                               const uint8_t* __restrict__ valid, int m,
                               int n, int p, int* __restrict__ counts,
                               float* __restrict__ sums) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  int d;
  if (j >= m || !accepted(dst, valid, j, n, &d)) return;
  atomicAdd(counts + d, 1);
  const float* row = payload + j * p;
  float* acc = sums + static_cast<int64_t>(d) * p;
  for (int c = 0; c < p; ++c) atomicAdd(acc + c, row[c]);
}

__global__ void ring_claim(const int* __restrict__ dst,
                           const uint8_t* __restrict__ valid, int m, int n,
                           const int* __restrict__ prev,
                           int* __restrict__ cur) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  int d;
  if (j >= m || !accepted(dst, valid, j, n, &d)) return;
  if (prev != nullptr && j <= prev[d]) return;
  atomicMin(cur + d, static_cast<int>(j));
}

__global__ void ring_gather(const int* __restrict__ mtype,
                            const float* __restrict__ payload, int n, int p,
                            int slots, const int* __restrict__ first,
                            const int* __restrict__ counts,
                            int* __restrict__ buf_t,
                            float* __restrict__ buf_p,
                            uint8_t* __restrict__ buf_v,
                            int* __restrict__ dropped) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  int over = 0;
  if (i < static_cast<int64_t>(n) * slots) {
    const int r = static_cast<int>(i / slots);
    const int k = static_cast<int>(i % slots);
    const int j = first[static_cast<int64_t>(k) * n + r];
    float* out = buf_p + i * p;
    if (j != INT_MAX) {
      buf_t[i] = mtype[j];
      buf_v[i] = 1;
      const float* src = payload + static_cast<int64_t>(j) * p;
      for (int c = 0; c < p; ++c) out[c] = src[c];
    } else {
      buf_t[i] = 0;
      buf_v[i] = 0;
      for (int c = 0; c < p; ++c) out[c] = 0.f;
    }
    if (k == 0) over = max(counts[r] - slots, 0);
  }
  // block-wide sum of the overflow, then one atomic per block
  for (int off = 16; off > 0; off >>= 1)
    over += __shfl_down_sync(0xffffffffu, over, off);
  __shared__ int warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = over;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    if (total != 0) atomicAdd(dropped, total);
  }
}

int blocks_for(int64_t items) {
  const int64_t b = (items + kThreads - 1) / kThreads;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

// K1. Outputs counts [n] and sums [n, p] must be zeroed by the caller.
extern "C" int ring_reduce(const void* dst, const void* payload,
                           const void* valid, int m, int n, int p,
                           void* counts, void* sums, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  ring_count_sum<<<blocks_for(m), kThreads, 0, s>>>(
      static_cast<const int*>(dst), static_cast<const float*>(payload),
      static_cast<const uint8_t*>(valid), m, n, p, static_cast<int*>(counts),
      static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

// K2. counts, sums and dropped [1] zeroed by the caller; first [slots, n]
// filled with INT_MAX; buf_t [n*slots], buf_p [n*slots, p], buf_v
// [n*slots] are fully written here.
extern "C" int ring_slots(const void* dst, const void* mtype,
                          const void* payload, const void* valid, int m,
                          int n, int p, int slots, void* counts, void* sums,
                          void* first, void* buf_t, void* buf_p, void* buf_v,
                          void* dropped, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int* d = static_cast<const int*>(dst);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int* f = static_cast<int*>(first);
  ring_count_sum<<<blocks_for(m), kThreads, 0, s>>>(
      d, static_cast<const float*>(payload), v, m, n, p,
      static_cast<int*>(counts), static_cast<float*>(sums));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 0; k < slots; ++k) {
    const int* prev = k == 0 ? nullptr : f + static_cast<int64_t>(k - 1) * n;
    ring_claim<<<blocks_for(m), kThreads, 0, s>>>(
        d, v, m, n, prev, f + static_cast<int64_t>(k) * n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ring_gather<<<blocks_for(static_cast<int64_t>(n) * slots), kThreads, 0,
                s>>>(static_cast<const int*>(mtype),
                     static_cast<const float*>(payload), n, p, slots, f,
                     static_cast<const int*>(counts),
                     static_cast<int*>(buf_t), static_cast<float*>(buf_p),
                     static_cast<uint8_t*>(buf_v),
                     static_cast<int*>(dropped));
  return static_cast<int>(cudaGetLastError());
}
