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
//   ring_sweep<CLAIM=false>  (K1 for float and bf16: two memsets, one
//                   launch) each thread takes ROWS rows, loads them all,
//                   then adds 1 to counts[d] and the payload row to
//                   sums[d, :]. Where P % 4 == 0 and the pointers are
//                   aligned, a row moves as one 16-byte (float) or 8-byte
//                   (bf16, widened to float4) load and one float4 vector
//                   atomic per 4 columns; other widths add column by
//                   column. Counts are exact; float sums land in a
//                   run-dependent order.
//   ring_sweep_elems (K1 for int32: two memsets, one launch) one lane per
//                   payload element e = j * P + c, so a warp covers 32
//                   consecutive words: each lane adds its word to
//                   sums[d, c], and the lane of column 0 adds 1 to
//                   counts[d].
//   ring_sweep<CLAIM=true>  (K2 launch 1 for float and bf16, after one
//                   memset of the integer scratch and one of the sums) the
//                   same sweep, one row a thread, plus a
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
//   ring_sweep_claim_elems (K2 launch 1 for int32) one row a lane for the
//                   accept, the count and the claim, as above; then the
//                   warp's 32 rows' payload words are added one lane a
//                   word, as ring_sweep_elems adds them.
//   ring_fill       (K2 launch 2) one thread per ring cell (d, k): copies
//                   type and payload of row m - first[d, k] into the cell,
//                   or zeros when the level is empty, and sums
//                   max(counts[d] - S, 0) into dropped. Where P % 4 == 0
//                   and the payload and the rings are aligned to 4
//                   elements, a cell's payload moves as 16-byte (float,
//                   int32) or 8-byte (bf16) words; other widths move
//                   column by column.
//
// Bound: memory bytes. Each row is read once and each output written once;
// the work per byte is one add. The sweeps read rows coalesced and send
// their count and sum atomics as fire-and-forget reductions (RED), which
// the 50 MB L2 absorbs. What costs most is the stream of atomic requests
// into random lines: on random traffic each array a row updates adds one
// such stream, and K2's claim is a third one (into `first`) whose result
// the thread waits for. Putting a recipient's count, levels and sums into
// one 32-byte record measured slower on every pattern: the three atomics
// then serialise on one sector, and a warp's coalesced atomics spread over
// 32 sectors. ring_fill's gather of type and payload by claimed row is
// random on random traffic. Hot recipients (fan-in collectors) serialise
// their atomics in L2.
//
// Payload types T (the reference's outputs take the payload's dtype):
// float, int32 and bf16, each with an accumulator A: float for float and
// bf16, int for int32 (exact; wraps as int32 arithmetic does). What bounds
// each typed sweep, and what its design does about it:
// - int32: sm_90 has no integer vector reduction (PTX red.v4 takes f32,
//   f16 and bf16 only), so a row cannot go out as one request as a float
//   row does. One thread per row would send P scalar REDs, each warp
//   instruction to 32 separate sum rows: P requests a row. With one lane
//   per element, a warp instruction covers 32 / P whole rows and sends
//   one request per distinct sum row, as the float4 path does, and its
//   payload load uses all 128 bytes. A lane works out its first element's
//   row and column with one 32-bit division and steps the rest. K2 keeps
//   one row a lane for the claim, whose round trip it waits on (one row a
//   thread keeps the most claims in flight), and takes each word's
//   recipient from the lane that owns its row (__shfl_sync), so its sums
//   cost what K1's do.
// - bf16: a bf16 accumulator would stop growing (256 + 1 rounds to 256 in
//   bf16), so bf16 sums land in a float32 scratch [n, p] and are rounded
//   once (round to nearest even): by `round_sums` after K1's sweep, by
//   ring_fill in K2. A float32 accumulator takes the float4 vector atomic,
//   so both sweeps widen each 8-byte group of 4 bf16 to a float4 and add
//   it with one red.global.add.v4.f32; `round_sums`, and ring_fill in the
//   thread of a recipient's first cell, read 16 bytes and write 8 at a
//   time.
// What bounds K2 in every dtype is then what it shares: the claim's
// atomicMax round trips into random lines of `first`, and ring_fill's
// gather of the claimed rows, random on random traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
// Rows per thread. K1 takes four, to keep more loads and reductions in
// flight (one and two measured within noise of four, eight slower). K2's
// sweep waits on its claims, and one row per thread (fewer registers, more
// threads resident) measured faster than two or four on random traffic.
constexpr int kReduceRows = 4;
constexpr int kClaimRows = 1;
// Payload elements per thread of the int32 K1 (ring_sweep_elems), all
// loaded before the first atomic.
constexpr int kReduceElems = 4;
// Payload elements of the int32 K2 sweep a lane loads before their
// atomics (its P elements go in groups of this many).
constexpr int kClaimElems = 4;

// the C entries' dtype codes (ops/cuda_mailbox.py DTYPES)
enum DtypeCode { kF32 = 0, kI32 = 1, kBF16 = 2 };

template <typename T>
struct Acc {
  using type = T;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};

// Four payload elements as one word: 16 bytes of float or int32, 8 of
// bf16 (ring_fill's bit copies).
template <typename T>
struct Word4 {
  using type = uint4;
};
template <>
struct Word4<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ int zero_of<int>() { return 0; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

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

// Four bf16 (8-byte aligned) as one 8-byte load, widened: a bf16 is the
// high half of the float32 with the same value.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Two floats rounded to bf16 (nearest even), packed low column first.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi)))
             << 16;
}

// The claim below level 0 (see the note at the top): `old` is what level
// 0 of `level` held before the claim of row value v there.
__device__ __forceinline__ void claim_down(int* __restrict__ level,
                                           int slots, int old, int v) {
  if (old == 0) return;  // took an empty level 0
  v = min(old, v);       // the later row of the two moves down
  for (int k = 1; k < slots; ++k) {
    const int prev = atomicMax(level + k, v);
    if (prev == 0) break;  // took an empty level
    v = min(v, prev);      // the later row moves down
  }
}

// Adds one payload row into acc. VEC (float and bf16): p % 4 == 0 and
// aligned rows, four columns a float4 vector atomic; `head` holds the
// row's first four columns, loaded ahead by the caller.
template <bool VEC, typename T>
__device__ __forceinline__ void add_row(const T* __restrict__ src,
                                        typename Acc<T>::type* __restrict__ acc,
                                        int p, float4 head) {
  if constexpr (VEC) {
    atomicAdd(reinterpret_cast<float4*>(acc), head);
    for (int c = 4; c < p; c += 4)
      atomicAdd(reinterpret_cast<float4*>(acc + c), load4(src + c));
  } else {
    for (int c = 0; c < p; ++c) atomicAdd(acc + c, widen(src[c]));
  }
}

// The sweep both kernels share: accept ROWS rows of this thread, load
// their first payload columns, count and sum them. With CLAIM, also the
// cascaded claim into first [n, slots].
template <int ROWS, bool VEC, bool CLAIM, typename T>
__global__ void __launch_bounds__(kThreads)
ring_sweep(const int* __restrict__ dst, const T* __restrict__ payload,
           const uint8_t* __restrict__ valid, int m, int n, int p,
           int slots, int* __restrict__ counts,
           typename Acc<T>::type* __restrict__ sums,
           int* __restrict__ first) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * ROWS +
                       threadIdx.x;
  int d[ROWS];
  float4 head[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t j = base + r * kThreads;
    d[r] = accept(dst, valid, j, m, n);
    if constexpr (VEC)
      head[r] = d[r] >= 0 ? load4(payload + j * p)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    else
      head[r] = make_float4(0.f, 0.f, 0.f, 0.f);
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
    add_row<VEC, T>(payload + j * p, sums + static_cast<int64_t>(d[r]) * p,
                    p, head[r]);
  }
  if (CLAIM) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      claim_down(first + static_cast<int64_t>(d[r]) * slots, slots, old[r],
                 m - static_cast<int>(base + r * kThreads));
  }
}

// int32 K2 sweep (see the note at the top). Lane l of a warp owns row
// j = row0 + l for the accept, the count and the claim, then adds
// elements l, l + 32, ... of the warp's 32 * p payload words: element x
// lies in row x / p of the warp and column x % p, worked out once (one
// 32-bit division) and stepped by step_rows = 32 / p rows plus step_cols
// = 32 % p columns. Every lane reaches every shuffle: rows past m and
// rejected rows carry d = -1 and add nothing.
__global__ void __launch_bounds__(kThreads)
ring_sweep_claim_elems(const int* __restrict__ dst,
                       const int* __restrict__ payload,
                       const uint8_t* __restrict__ valid, int m, int n,
                       int p, int slots, int step_rows, int step_cols,
                       int* __restrict__ counts, int* __restrict__ sums,
                       int* __restrict__ first) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int d = accept(dst, valid, j, m, n);
  const int v = d < 0 ? 0 : m - static_cast<int>(j);
  int* level = first + static_cast<int64_t>(d) * slots;
  const int old = d < 0 ? 0 : atomicMax(level, v);
  if (d >= 0) atomicAdd(counts + d, 1);
  const int* src = payload + (j - lane) * p + lane;
  int r = lane / p;
  int c = lane - r * p;
  for (int k0 = 0; k0 < p; k0 += kClaimElems) {
    int dd[kClaimElems], cc[kClaimElems], w[kClaimElems];
#pragma unroll
    for (int i = 0; i < kClaimElems; ++i) {
      dd[i] = -1;
      if (k0 + i < p) {  // the same for every lane of the warp
        const int dr = __shfl_sync(0xffffffffu, d, r);
        if (dr >= 0) {
          dd[i] = dr;
          cc[i] = c;
          w[i] = __ldg(src + (k0 + i) * 32);
        }
        r += step_rows;
        c += step_cols;
        if (c >= p) {
          c -= p;
          ++r;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kClaimElems; ++i)
      if (dd[i] >= 0)
        atomicAdd(sums + static_cast<int64_t>(dd[i]) * p + cc[i], w[i]);
  }
  claim_down(level, slots, old, v);
}

// int32 K1: one lane per payload element (see the note at the top). Lane
// t of block b starts at element e = b * kThreads * ELEMS + t and steps
// kThreads elements: step_rows = kThreads / p rows plus step_cols =
// kThreads % p columns. Every element is loaded before the first atomic.
template <int ELEMS>
__global__ void __launch_bounds__(kThreads)
ring_sweep_elems(const int* __restrict__ dst, const int* __restrict__ payload,
                 const uint8_t* __restrict__ valid, int m, int n, int p,
                 int step_rows, int step_cols, int* __restrict__ counts,
                 int* __restrict__ sums) {
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kThreads * ELEMS +
                     threadIdx.x;
  int64_t j;
  int c;
  if (e0 <= 0xffffffffLL) {  // a 32-bit division wherever it suffices
    const unsigned e = static_cast<unsigned>(e0);
    const unsigned q = e / static_cast<unsigned>(p);
    j = q;
    c = static_cast<int>(e - q * static_cast<unsigned>(p));
  } else {
    j = e0 / p;
    c = static_cast<int>(e0 - j * p);
  }
  const int64_t elems = static_cast<int64_t>(m) * p;
  int d[ELEMS], col[ELEMS], v[ELEMS];
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int64_t e = e0 + k * kThreads;
    d[k] = accept(dst, valid, j, m, n);  // -1 past the last row
    v[k] = e < elems ? __ldg(payload + e) : 0;
    col[k] = c;
    j += step_rows;
    c += step_cols;
    if (c >= p) {
      c -= p;
      ++j;
    }
  }
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    if (d[k] < 0) continue;
    if (col[k] == 0) atomicAdd(counts + d[k], 1);
    atomicAdd(sums + static_cast<int64_t>(d[k]) * p + col[k], v[k]);
  }
}

// bf16 sums: the float32 accumulator rounded once into the output. VEC
// (16-byte aligned acc, 8-byte aligned out): four elements a thread, the
// last thread also the count % 4 tail.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
round_sums(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
           int64_t count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (VEC) {
    const int64_t e = i * 4;
    if (e + 4 <= count) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(acc) + i);
      reinterpret_cast<uint2*>(out)[i] =
          make_uint2(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w));
    } else {
      for (int64_t k = e; k < count; ++k) out[k] = __float2bfloat16(acc[k]);
    }
  } else {
    if (i < count) out[i] = __float2bfloat16(acc[i]);
  }
}

// One thread per ring cell. VEC (p % 4 == 0, payload and buf_p aligned to
// 4 elements): a cell's payload moves as Word4 bit copies. For bf16, the
// thread of each recipient's first cell also rounds its row of the
// float32 accumulator `acc` into `sums`: 16 bytes in and 8 out at a time
// where round_vec (p % 4 == 0, acc 16-byte and sums 8-byte aligned), else
// column by column.
template <bool VEC, typename T>
__global__ void __launch_bounds__(kThreads)
ring_fill(const int* __restrict__ mtype, const T* __restrict__ payload,
          int m, int n, int p, int slots, const int* __restrict__ counts,
          const int* __restrict__ first, int* __restrict__ buf_t,
          T* __restrict__ buf_p, uint8_t* __restrict__ buf_v,
          int* __restrict__ dropped, const float* __restrict__ acc,
          T* __restrict__ sums, bool round_vec) {
  using W = typename Word4<T>::type;
  // 32-bit cell index (the caller keeps n * slots below 2^31): a 64-bit
  // division per thread measured slower
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  int over = 0;
  if (i < static_cast<unsigned>(n) * slots) {
    const int f = first[i];           // first is [n, slots]: cell order
    T* out = buf_p + static_cast<int64_t>(i) * p;
    if (f != 0) {
      const int64_t j = m - f;
      const T* src = payload + j * p;
      buf_t[i] = mtype[j];
      buf_v[i] = 1;
      if constexpr (VEC) {
        for (int c = 0; c < p; c += 4)
          *reinterpret_cast<W*>(out + c) =
              __ldg(reinterpret_cast<const W*>(src + c));
      } else {
        for (int c = 0; c < p; ++c) out[c] = src[c];
      }
    } else {
      buf_t[i] = 0;
      buf_v[i] = 0;
      if constexpr (VEC) {
        for (int c = 0; c < p; c += 4) *reinterpret_cast<W*>(out + c) = W{};
      } else {
        for (int c = 0; c < p; ++c) out[c] = zero_of<T>();
      }
    }
    if (i % slots == 0) {
      const unsigned d = i / slots;
      over = max(counts[d] - slots, 0);
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const int64_t row = static_cast<int64_t>(d) * p;
        if (round_vec) {
          for (int c = 0; c < p; c += 4) {
            const float4 a =
                __ldg(reinterpret_cast<const float4*>(acc + row + c));
            *reinterpret_cast<uint2*>(sums + row + c) =
                make_uint2(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w));
          }
        } else {
          for (int c = 0; c < p; ++c)
            sums[row + c] = __float2bfloat16(acc[row + c]);
        }
      }
    }
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

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

bool aligned16(const void* ptr) { return aligned(ptr, 16); }

// The row sweep of float and bf16 (int32 sweeps one lane per element):
// float4 rows where vec.
template <bool CLAIM, typename T>
void launch_sweep(bool vec, const int* dst, const T* payload,
                  const uint8_t* valid, int m, int n, int p, int slots,
                  int* counts, typename Acc<T>::type* sums, int* first,
                  cudaStream_t s) {
  static_assert(!std::is_same<T, int>::value, "int32 sweeps by element");
  constexpr int rows = CLAIM ? kClaimRows : kReduceRows;
  const int grid = blocks_for(m, kThreads * rows);
  if (vec)
    ring_sweep<rows, true, CLAIM, T><<<grid, kThreads, 0, s>>>(
        dst, payload, valid, m, n, p, slots, counts, sums, first);
  else
    ring_sweep<rows, false, CLAIM, T><<<grid, kThreads, 0, s>>>(
        dst, payload, valid, m, n, p, slots, counts, sums, first);
}

// K1 for payload type T: zero counts and the accumulator, sweep (int32 by
// element, the others by row), and for bf16 round the accumulator into
// sums.
template <typename T>
int reduce_impl(const void* dst, const void* payload, const void* valid,
                int m, int n, int p, void* counts, void* sums, void* acc,
                cudaStream_t s) {
  using A = typename Acc<T>::type;
  constexpr bool kRound = !std::is_same<A, T>::value;
  A* into = kRound ? static_cast<A*>(acc) : static_cast<A*>(sums);
  if (into == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elems = int64_t(n) * p;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * int64_t(n), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(into, 0, sizeof(A) * elems, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* d = static_cast<const int*>(dst);
  const auto* v = static_cast<const uint8_t*>(valid);
  if constexpr (std::is_same<T, int>::value) {
    const int64_t blocks =
        (int64_t(m) * p + kThreads * kReduceElems - 1) /
        (kThreads * kReduceElems);
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    ring_sweep_elems<kReduceElems>
        <<<blocks < 1 ? 1 : static_cast<int>(blocks), kThreads, 0, s>>>(
            d, static_cast<const int*>(payload), v, m, n, p, kThreads / p,
            kThreads % p, static_cast<int*>(counts), into);
  } else {
    const bool vec = p % 4 == 0 && aligned(payload, 4 * sizeof(T)) &&
                     aligned16(into);
    launch_sweep<false, T>(vec, d, static_cast<const T*>(payload), v, m, n,
                           p, 0, static_cast<int*>(counts), into, nullptr,
                           s);
  }
  if constexpr (kRound) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* out = static_cast<__nv_bfloat16*>(sums);
    if (aligned16(into) && aligned(out, 8))
      round_sums<true><<<blocks_for((elems + 3) / 4, kThreads), kThreads, 0,
                         s>>>(into, out, elems);
    else
      round_sums<false><<<blocks_for(elems, kThreads), kThreads, 0, s>>>(
          into, out, elems);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 for payload type T (see ring_slots below).
template <typename T>
int slots_impl(const void* dst, const void* mtype, const void* payload,
               const void* valid, int m, int n, int p, int slots,
               void* scratch, void* sums, void* acc, void* buf_t,
               void* buf_p, void* buf_v, cudaStream_t s) {
  using A = typename Acc<T>::type;
  constexpr bool kRound = !std::is_same<A, T>::value;
  A* into = kRound ? static_cast<A*>(acc) : static_cast<A*>(sums);
  if (into == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cells = int64_t(n) * slots;
  int* counts = static_cast<int*>(scratch);
  int* first = counts + n;
  int* dropped = first + cells;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(int) * (n + cells + 1), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(into, 0, sizeof(A) * int64_t(n) * p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // words of 4 elements: payload rows for the float4 sweep (float, bf16)
  // and for ring_fill's copies (every type)
  const bool rows4 = p % 4 == 0 && aligned(payload, 4 * sizeof(T));
  const bool sweep_vec = rows4 && aligned16(into);
  const bool fill_vec = rows4 && aligned(buf_p, 4 * sizeof(T));
  const auto* d = static_cast<const int*>(dst);
  const auto* pay = static_cast<const T*>(payload);
  const auto* v = static_cast<const uint8_t*>(valid);
  if constexpr (std::is_same<T, int>::value)
    ring_sweep_claim_elems<<<blocks_for(m, kThreads), kThreads, 0, s>>>(
        d, pay, v, m, n, p, slots, 32 / p, 32 % p, counts, into, first);
  else
    launch_sweep<true, T>(sweep_vec, d, pay, v, m, n, p, slots, counts,
                          into, first, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = blocks_for(cells, kThreads);
  const auto* t = static_cast<const int*>(mtype);
  auto* bt = static_cast<int*>(buf_t);
  auto* bp = static_cast<T*>(buf_p);
  auto* bv = static_cast<uint8_t*>(buf_v);
  const float* round_from = nullptr;
  T* round_into = nullptr;
  bool round_vec = false;
  if constexpr (kRound) {
    round_from = into;
    round_into = static_cast<T*>(sums);
    round_vec = p % 4 == 0 && aligned16(into) && aligned(sums, 8);
  }
  if (fill_vec)
    ring_fill<true, T><<<grid, kThreads, 0, s>>>(
        t, pay, m, n, p, slots, counts, first, bt, bp, bv, dropped,
        round_from, round_into, round_vec);
  else
    ring_fill<false, T><<<grid, kThreads, 0, s>>>(
        t, pay, m, n, p, slots, counts, first, bt, bp, bv, dropped,
        round_from, round_into, round_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. counts [n] int32 and sums [n, p] of the payload's type (dtype: 0
// float32, 1 int32, 2 bf16) are zeroed here; for bf16, acc is a float32
// [n, p] accumulator (zeroed here, then rounded into sums), else unused.
extern "C" int ring_reduce(const void* dst, const void* payload,
                           const void* valid, int m, int n, int p, int dtype,
                           void* counts, void* sums, void* acc,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return reduce_impl<float>(dst, payload, valid, m, n, p, counts, sums,
                                acc, s);
    case kI32:
      return reduce_impl<int>(dst, payload, valid, m, n, p, counts, sums,
                              acc, s);
    case kBF16:
      return reduce_impl<__nv_bfloat16>(dst, payload, valid, m, n, p,
                                        counts, sums, acc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2. scratch is int32 [n + n * slots + 1]: counts [n], then first
// [n, slots], then dropped [1]; it and the sums' accumulator (sums, or acc
// for bf16) are zeroed here. buf_t [n * slots] int32, buf_p
// [n * slots, p] of the payload's type and buf_v [n * slots] bool are
// fully written, and for bf16 sums [n, p] too. n * slots must stay below
// 2^31.
extern "C" int ring_slots(const void* dst, const void* mtype,
                          const void* payload, const void* valid, int m,
                          int n, int p, int slots, int dtype, void* scratch,
                          void* sums, void* acc, void* buf_t, void* buf_p,
                          void* buf_v, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return slots_impl<float>(dst, mtype, payload, valid, m, n, p, slots,
                               scratch, sums, acc, buf_t, buf_p, buf_v, s);
    case kI32:
      return slots_impl<int>(dst, mtype, payload, valid, m, n, p, slots,
                             scratch, sums, acc, buf_t, buf_p, buf_v, s);
    case kBF16:
      return slots_impl<__nv_bfloat16>(dst, mtype, payload, valid, m, n, p,
                                       slots, scratch, sums, acc, buf_t,
                                       buf_p, buf_v, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
