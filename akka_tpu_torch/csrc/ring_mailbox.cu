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
// the order they land in. A row j is accepted when valid[j] and
// 0 <= dst[j] < n; other rows are skipped, not clipped.
//
//   ring_sweep<CLAIM=false>  (K1: two memsets, one launch) each thread
//                   takes ROWS rows, loads them all, then adds 1 to
//                   counts[d] and the payload row to sums[d, :]. Where
//                   P % 4 == 0 and the pointers are 16-byte aligned, a row
//                   moves as one 16-byte load and one float4 vector atomic
//                   per 4 columns; other widths add column by column.
//                   Counts are exact; float sums land in a run-dependent
//                   order.
//   ring_sweep<CLAIM=true>  (K2 launch 1, after one memset of the integer
//                   scratch and one of the sums) the same sweep, plus a
//                   cascaded claim: levels first[d, 0..S-1] keep the S
//                   earliest rows of recipient d, stored as m - j so that
//                   the empty mark is 0 and "earlier" is "larger"
//                   (atomicMax). A row offers v = m - j at level 0; whoever
//                   loses (the smaller value) moves one level down, until a
//                   level was empty or the loser falls off the last level.
//                   Each value offered to a level stays there or passes
//                   down once, so level k ends with the (k+1)-th earliest
//                   row whatever order the atomics land in: the rings are
//                   bit-identical to the TPU's. Most rows pay one claim
//                   atomic; only a recipient's later arrivals pay more, at
//                   most S.
//   ring_fill       (K2 launch 2) one thread per ring cell (d, k): copies
//                   type and payload of row m - first[d, k] into the cell,
//                   or zeros when the level is empty, and sums
//                   max(counts[d] - S, 0) into dropped.
//
// Bound: memory bytes. Each row is read once and each output written once;
// the work per byte is one add. The sweeps read rows coalesced and send
// their count and sum atomics as fire-and-forget reductions (RED), which
// the 50 MB L2 absorbs. What costs most is the stream of atomics into
// random lines: on random traffic each array a row updates adds one such
// stream, and K2's claim is a third one (into `first`) whose result the
// thread waits for. Putting a recipient's count, levels and sums into one
// 32-byte record measured slower on every pattern: the three atomics then
// serialise on one sector, and a warp's coalesced atomics spread over 32
// sectors. ring_fill's gather of type and payload by claimed row is random
// on random traffic. Hot recipients (fan-in collectors) serialise their
// atomics in L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Rows per thread. K1 takes four, to keep more loads and reductions in
// flight (one and two measured within noise of four, eight slower). K2's
// sweep waits on its claims, and one row per thread (fewer registers, more
// threads resident) measured faster than two or four on random traffic.
constexpr int kReduceRows = 4;
constexpr int kClaimRows = 1;

// d when row j is accepted, else -1.
__device__ __forceinline__ int accept(const int* __restrict__ dst,
                                      const uint8_t* __restrict__ valid,
                                      int64_t j, int m, int n) {
  if (j >= m) return -1;
  const int d = dst[j];
  return (valid[j] != 0 && d >= 0 && d < n) ? d : -1;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Adds one payload row into acc. VEC: p % 4 == 0 and 16-byte aligned rows;
// `head` holds the row's first four columns, loaded ahead by the caller.
template <bool VEC>
__device__ __forceinline__ void add_row(const float* __restrict__ src,
                                        float* __restrict__ acc, int p,
                                        float4 head) {
  if (VEC) {
    atomicAdd(reinterpret_cast<float4*>(acc), head);
    for (int c = 4; c < p; c += 4)
      atomicAdd(reinterpret_cast<float4*>(acc + c), load4(src + c));
  } else {
    for (int c = 0; c < p; ++c) atomicAdd(acc + c, src[c]);
  }
}

// The sweep both kernels share: accept ROWS rows of this thread, load
// their first payload columns, count and sum them. With CLAIM, also the
// cascaded claim into first [n, slots].
template <int ROWS, bool VEC, bool CLAIM>
__global__ void __launch_bounds__(kThreads)
ring_sweep(const int* __restrict__ dst, const float* __restrict__ payload,
           const uint8_t* __restrict__ valid, int m, int n, int p,
           int slots, int* __restrict__ counts, float* __restrict__ sums,
           int* __restrict__ first) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * ROWS +
                       threadIdx.x;
  int d[ROWS];
  float4 head[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t j = base + r * kThreads;
    d[r] = accept(dst, valid, j, m, n);
    head[r] = VEC && d[r] >= 0 ? load4(payload + j * p)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int old[ROWS];  // what level 0 held before this row's claim
  if (CLAIM) {
    // level 0 of every row first, so their round trips overlap
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int v = m - static_cast<int>(base + r * kThreads);
      old[r] = d[r] < 0
                   ? 0
                   : atomicMax(first + static_cast<int64_t>(d[r]) * slots, v);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (d[r] < 0) continue;
    const int64_t j = base + r * kThreads;
    atomicAdd(counts + d[r], 1);
    add_row<VEC>(payload + j * p, sums + static_cast<int64_t>(d[r]) * p, p,
                 head[r]);
  }
  if (CLAIM) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (old[r] == 0) continue;  // took an empty level 0
      // the later row of the two moves down
      int v = min(old[r], m - static_cast<int>(base + r * kThreads));
      int* level = first + static_cast<int64_t>(d[r]) * slots;
      for (int k = 1; k < slots; ++k) {
        const int prev = atomicMax(level + k, v);
        if (prev == 0) break;     // took an empty level
        v = min(v, prev);         // the later row moves down
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
ring_fill(const int* __restrict__ mtype, const float* __restrict__ payload,
          int m, int n, int p, int slots, const int* __restrict__ counts,
          const int* __restrict__ first, int* __restrict__ buf_t,
          float* __restrict__ buf_p, uint8_t* __restrict__ buf_v,
          int* __restrict__ dropped) {
  // 32-bit cell index (the caller keeps n * slots below 2^31): a 64-bit
  // division per thread measured slower
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  int over = 0;
  if (i < static_cast<unsigned>(n) * slots) {
    const int f = first[i];           // first is [n, slots]: cell order
    float* out = buf_p + static_cast<int64_t>(i) * p;
    if (f != 0) {
      const int64_t j = m - f;
      const float* src = payload + j * p;
      buf_t[i] = mtype[j];
      buf_v[i] = 1;
      if (VEC) {
        for (int c = 0; c < p; c += 4)
          *reinterpret_cast<float4*>(out + c) = load4(src + c);
      } else {
        for (int c = 0; c < p; ++c) out[c] = src[c];
      }
    } else {
      buf_t[i] = 0;
      buf_v[i] = 0;
      if (VEC) {
        for (int c = 0; c < p; c += 4)
          *reinterpret_cast<float4*>(out + c) = make_float4(0, 0, 0, 0);
      } else {
        for (int c = 0; c < p; ++c) out[c] = 0.f;
      }
    }
    if (i % slots == 0) over = max(counts[i / slots] - slots, 0);
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

int blocks_for(int64_t items, int per_block) {
  const int64_t b = (items + per_block - 1) / per_block;
  return b < 1 ? 1 : static_cast<int>(b);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <bool CLAIM>
void launch_sweep(bool vec, const int* dst, const float* payload,
                  const uint8_t* valid, int m, int n, int p, int slots,
                  int* counts, float* sums, int* first, cudaStream_t s) {
  constexpr int rows = CLAIM ? kClaimRows : kReduceRows;
  const int grid = blocks_for(m, kThreads * rows);
  if (vec)
    ring_sweep<rows, true, CLAIM><<<grid, kThreads, 0, s>>>(
        dst, payload, valid, m, n, p, slots, counts, sums, first);
  else
    ring_sweep<rows, false, CLAIM><<<grid, kThreads, 0, s>>>(
        dst, payload, valid, m, n, p, slots, counts, sums, first);
}

}  // namespace

// K1. counts [n] int32 and sums [n, p] float32 are zeroed here.
extern "C" int ring_reduce(const void* dst, const void* payload,
                           const void* valid, int m, int n, int p,
                           void* counts, void* sums, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * int64_t(n), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(sums, 0, sizeof(float) * int64_t(n) * p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = p % 4 == 0 && aligned16(payload) && aligned16(sums);
  launch_sweep<false>(vec, static_cast<const int*>(dst),
                      static_cast<const float*>(payload),
                      static_cast<const uint8_t*>(valid), m, n, p, 0,
                      static_cast<int*>(counts), static_cast<float*>(sums),
                      nullptr, s);
  return static_cast<int>(cudaGetLastError());
}

// K2. scratch is int32 [n + n * slots + 1]: counts [n], then first
// [n, slots], then dropped [1]; it and sums [n, p] are zeroed here.
// buf_t [n * slots] int32, buf_p [n * slots, p] float32 and buf_v
// [n * slots] bool are fully written. n * slots must stay below 2^31.
extern "C" int ring_slots(const void* dst, const void* mtype,
                          const void* payload, const void* valid, int m,
                          int n, int p, int slots, void* scratch, void* sums,
                          void* buf_t, void* buf_p, void* buf_v,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t cells = int64_t(n) * slots;
  int* counts = static_cast<int*>(scratch);
  int* first = counts + n;
  int* dropped = first + cells;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(int) * (n + cells + 1), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(sums, 0, sizeof(float) * int64_t(n) * p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = p % 4 == 0 && aligned16(payload) && aligned16(sums) &&
                   aligned16(buf_p);
  const auto* pay = static_cast<const float*>(payload);
  launch_sweep<true>(vec, static_cast<const int*>(dst), pay,
                     static_cast<const uint8_t*>(valid), m, n, p, slots,
                     counts, static_cast<float*>(sums), first, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = blocks_for(cells, kThreads);
  const auto* t = static_cast<const int*>(mtype);
  auto* bt = static_cast<int*>(buf_t);
  auto* bp = static_cast<float*>(buf_p);
  auto* bv = static_cast<uint8_t*>(buf_v);
  if (vec)
    ring_fill<true><<<grid, kThreads, 0, s>>>(t, pay, m, n, p, slots, counts,
                                              first, bt, bp, bv, dropped);
  else
    ring_fill<false><<<grid, kThreads, 0, s>>>(t, pay, m, n, p, slots,
                                               counts, first, bt, bp, bv,
                                               dropped);
  return static_cast<int>(cudaGetLastError());
}
