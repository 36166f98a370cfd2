// Native runtime substrate for akka_tpu_torch.
//
// The port's own copy of akka_tpu/native/src/akka_native.cpp (commit
// 001ef4f). The MPSC queue and the wheel timer are unchanged. The stager
// differs in one place: a stage that meets a drain waits for it and
// retries without a cap (the reference gives up after 2^16 fenced
// attempts and counts the batch as dropped, though the buffer is not
// full); only a genuinely full buffer drops.
//
// The reference's performance layer is JVM-intrinsic (sun.misc.Unsafe CAS ops,
// akka-actor/src/main/java/akka/dispatch/AbstractNodeQueue.java lock-free MPSC
// queues, akka-actor/src/main/scala/akka/actor/LightArrayRevolverScheduler.scala
// hashed-wheel timer, akka-remote envelope buffer pools). This library is the
// C++ equivalent (SURVEY.md §2.10 items 1, 2, 5):
//
//  1. aq_mpsc_*   — Vyukov non-intrusive MPSC queue: many producer threads,
//                   one consumer, no locks (AbstractNodeQueue parity).
//  2. aq_timer_*  — hashed-wheel timer on a dedicated tick thread; expired
//                   timer ids drain through a fired-queue the host polls
//                   (LightArrayRevolverScheduler parity).
//  3. aq_stager_* — preallocated message staging buffer: producers reserve
//                   slots with one atomic fetch_add and memcpy fixed-width
//                   payloads; the consumer drains a contiguous block for
//                   zero-copy device upload (EnvelopeBufferPool parity, host
//                   side of the batched runtime's inbox).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ======================== 1. MPSC queue ====================================

struct MpscNode {
    std::atomic<MpscNode*> next;
    uint64_t value;
};

struct MpscQueue {
    std::atomic<MpscNode*> head;  // producers push here
    MpscNode* tail;               // consumer pops here
    MpscNode stub;
    std::atomic<int64_t> size;
    std::atomic<bool> closed;     // late sends no-op (becomeClosed parity)
};

void* aq_mpsc_create() {
    auto* q = new MpscQueue();
    q->stub.next.store(nullptr, std::memory_order_relaxed);
    q->head.store(&q->stub, std::memory_order_relaxed);
    q->tail = &q->stub;
    q->size.store(0, std::memory_order_relaxed);
    q->closed.store(false, std::memory_order_relaxed);
    return q;
}

void aq_mpsc_enqueue(void* h, uint64_t v) {
    auto* q = static_cast<MpscQueue*>(h);
    if (q->closed.load(std::memory_order_acquire)) return;
    auto* n = new MpscNode();
    n->value = v;
    n->next.store(nullptr, std::memory_order_relaxed);
    MpscNode* prev = q->head.exchange(n, std::memory_order_acq_rel);
    prev->next.store(n, std::memory_order_release);
    q->size.fetch_add(1, std::memory_order_relaxed);
}

// returns 1 and sets *out on success, 0 when empty
int aq_mpsc_dequeue(void* h, uint64_t* out) {
    auto* q = static_cast<MpscQueue*>(h);
    MpscNode* tail = q->tail;
    MpscNode* next = tail->next.load(std::memory_order_acquire);
    if (next == nullptr) return 0;
    *out = next->value;
    q->tail = next;
    if (tail != &q->stub) delete tail;
    q->size.fetch_sub(1, std::memory_order_relaxed);
    return 1;
}

int64_t aq_mpsc_count(void* h) {
    return static_cast<MpscQueue*>(h)->size.load(std::memory_order_relaxed);
}

int64_t aq_mpsc_drain(void* h, uint64_t* out, int64_t max) {
    int64_t n = 0;
    while (n < max && aq_mpsc_dequeue(h, out + n)) n++;
    return n;
}

// Mark closed: late producers no-op. Flag-only on purpose — draining here
// would make close a second concurrent consumer racing the real consumer's
// dequeue (double-delete of q->tail on a Vyukov queue). Queued nodes and
// the struct are reclaimed in aq_mpsc_destroy, called only when no thread
// can hold the handle — mirrors the reference's becomeClosed mailbox swap
// routing late senders to dead letters.
void aq_mpsc_close(void* h) {
    static_cast<MpscQueue*>(h)->closed.store(true, std::memory_order_release);
}

void aq_mpsc_destroy(void* h) {
    auto* q = static_cast<MpscQueue*>(h);
    uint64_t scratch;
    while (aq_mpsc_dequeue(h, &scratch)) {}
    // dequeue defers deleting the node it leaves as tail; reclaim it
    if (q->tail != &q->stub) delete q->tail;
    delete q;
}

// ======================== 2. hashed-wheel timer ============================

struct TimerEntry {
    uint64_t id;
    uint64_t deadline_tick;   // absolute tick at which to fire
    uint64_t interval_ticks;  // 0 = one-shot
    bool cancelled;
};

struct WheelTimer {
    std::vector<std::vector<TimerEntry>> wheel;
    uint64_t wheel_mask;
    uint64_t tick_ns;
    uint64_t current_tick;
    std::mutex mu;                      // guards wheel + cancel set
    std::vector<uint64_t> fired;        // expired ids awaiting poll
    std::condition_variable fired_cv;
    std::atomic<bool> stop;
    std::thread ticker;

    void run() {
        auto next = std::chrono::steady_clock::now();
        while (!stop.load(std::memory_order_relaxed)) {
            next += std::chrono::nanoseconds(tick_ns);
            std::this_thread::sleep_until(next);
            std::unique_lock<std::mutex> lk(mu);
            current_tick++;
            auto& slot = wheel[current_tick & wheel_mask];
            bool any = false;
            // Reschedules are collected and appended AFTER the iteration:
            // pushing into the slot being walked would re-visit an entry in
            // the same pass (an exact-multiple interval lands back in this
            // slot), firing and re-appending forever. Absolute deadlines
            // (not revolution counts) make same-slot entries with a future
            // deadline simply skip until their tick arrives.
            std::vector<TimerEntry> resched;
            for (size_t i = 0; i < slot.size();) {
                TimerEntry& e = slot[i];
                if (e.cancelled) {
                    slot.erase(slot.begin() + i);
                    continue;
                }
                if (e.deadline_tick > current_tick) {
                    i++;
                    continue;
                }
                fired.push_back(e.id);
                any = true;
                if (e.interval_ticks > 0) {
                    TimerEntry re = e;
                    re.deadline_tick = current_tick + re.interval_ticks;
                    resched.push_back(re);
                }
                slot.erase(slot.begin() + i);
            }
            for (auto& re : resched)
                wheel[re.deadline_tick & wheel_mask].push_back(re);
            if (any) fired_cv.notify_all();
        }
        fired_cv.notify_all();
    }
};

void* aq_timer_create(uint64_t tick_ns, uint64_t wheel_size_pow2) {
    auto* t = new WheelTimer();
    uint64_t size = 1;
    while (size < wheel_size_pow2) size <<= 1;
    t->wheel.resize(size);
    t->wheel_mask = size - 1;
    t->tick_ns = tick_ns < 100000 ? 100000 : tick_ns;  // >= 0.1ms
    t->current_tick = 0;
    t->stop.store(false);
    t->ticker = std::thread([t] { t->run(); });
    return t;
}

void aq_timer_schedule(void* h, uint64_t id, uint64_t delay_ns,
                       uint64_t interval_ns) {
    auto* t = static_cast<WheelTimer*>(h);
    std::unique_lock<std::mutex> lk(t->mu);
    uint64_t delay_ticks = delay_ns / t->tick_ns;
    if (delay_ticks == 0) delay_ticks = 1;
    uint64_t target = t->current_tick + delay_ticks;
    TimerEntry e;
    e.id = id;
    e.deadline_tick = target;
    e.interval_ticks = interval_ns ? (interval_ns / t->tick_ns ? interval_ns / t->tick_ns : 1) : 0;
    e.cancelled = false;
    t->wheel[target & t->wheel_mask].push_back(e);
}

void aq_timer_cancel(void* h, uint64_t id) {
    auto* t = static_cast<WheelTimer*>(h);
    std::unique_lock<std::mutex> lk(t->mu);
    for (auto& slot : t->wheel)
        for (auto& e : slot)
            if (e.id == id) e.cancelled = true;
}

// blocking poll of expired ids; returns count written to out (<= max)
int64_t aq_timer_poll(void* h, uint64_t* out, int64_t max,
                      int64_t timeout_ms) {
    auto* t = static_cast<WheelTimer*>(h);
    std::unique_lock<std::mutex> lk(t->mu);
    if (t->fired.empty()) {
        t->fired_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms));
    }
    int64_t n = 0;
    while (n < max && !t->fired.empty()) {
        out[n++] = t->fired.front();
        t->fired.erase(t->fired.begin());
    }
    return n;
}

void aq_timer_destroy(void* h) {
    auto* t = static_cast<WheelTimer*>(h);
    t->stop.store(true);
    if (t->ticker.joinable()) t->ticker.join();
    delete t;
}

// ======================== 3. message stager ================================

struct Stager {
    int64_t capacity;
    int64_t payload_bytes;
    std::atomic<int64_t> cursor;      // monotonic reservation counter
    std::atomic<int64_t> committed;   // slots fully written
    std::atomic<int64_t> pending;     // producers between reserve and commit
    std::atomic<bool> draining;       // consumer mid-drain (producers wait)
    std::atomic<int64_t> epoch;       // completed drains (full-vs-fence tiebreak)
    int32_t* dst;
    uint8_t* payload;
    std::atomic<int64_t> dropped;
};

void* aq_stager_create(int64_t capacity, int64_t payload_bytes) {
    auto* s = new Stager();
    s->capacity = capacity;
    s->payload_bytes = payload_bytes;
    s->cursor.store(0);
    s->committed.store(0);
    s->pending.store(0);
    s->draining.store(false);
    s->epoch.store(0);
    s->dst = new int32_t[capacity];
    s->payload = new uint8_t[capacity * payload_bytes];
    s->dropped.store(0);
    return s;
}

// thread-safe: reserve with one fetch_add, memcpy, then commit. All-or-
// nothing per batch. A batch colliding with an in-flight drain WAITS for
// the drain and retries, with no cap on the retries: only a genuinely
// full buffer drops (bounded-mailbox overflow semantics); a concurrent
// flush never loses tells. The wait yields, then sleeps in short naps
// once the drain has been descheduled for a while.
static void stager_backoff(int64_t& waits) {
    if (++waits < 64) {
        std::this_thread::yield();
    } else {
        std::this_thread::sleep_for(std::chrono::microseconds(20));
    }
}

int64_t aq_stager_stage(void* h, int64_t k, const int32_t* dsts,
                        const uint8_t* payloads) {
    auto* s = static_cast<Stager*>(h);
    int64_t waits = 0;
    for (;;) {
        if (s->draining.load(std::memory_order_acquire)) {
            stager_backoff(waits);
            continue;
        }
        int64_t seen_epoch = s->epoch.load(std::memory_order_acquire);
        s->pending.fetch_add(1, std::memory_order_acq_rel);
        int64_t start = s->cursor.fetch_add(k, std::memory_order_acq_rel);
        if (start + k <= s->capacity) {
            std::memcpy(s->dst + start, dsts, k * sizeof(int32_t));
            std::memcpy(s->payload + start * s->payload_bytes, payloads,
                        k * s->payload_bytes);
            s->committed.fetch_add(k, std::memory_order_acq_rel);
            s->pending.fetch_sub(1, std::memory_order_acq_rel);
            return k;
        }
        s->pending.fetch_sub(1, std::memory_order_acq_rel);
        // "full" is only believable if NO drain was in flight around the
        // failed reservation: a drain that completed between our decrement
        // and this check (draining back to false, epoch bumped) emptied the
        // buffer — retry instead of falsely dropping into an empty stager
        if (!s->draining.load(std::memory_order_acquire) &&
            s->epoch.load(std::memory_order_acquire) == seen_epoch) {
            // not a drain fence: the buffer is genuinely full
            s->dropped.fetch_add(k, std::memory_order_relaxed);
            return 0;
        }
        stager_backoff(waits);  // fenced by the drain: wait and retry
    }
}

int64_t aq_stager_count(void* h) {
    return static_cast<Stager*>(h)->committed.load(std::memory_order_acquire);
}

int64_t aq_stager_dropped(void* h) {
    return static_cast<Stager*>(h)->dropped.load(std::memory_order_relaxed);
}

// single-consumer drain: copies the staged block out and resets. Waits for
// in-flight producers (between reserve and commit) to finish; producers
// arriving during the drain see a beyond-capacity cursor, wait for the
// drain and retry. committed is zeroed BEFORE the cursor so a post-reset
// stage can never be lost.
int64_t aq_stager_drain(void* h, int32_t* dst_out, uint8_t* payload_out) {
    auto* s = static_cast<Stager*>(h);
    // flag first (late producers park), then fence the cursor so producers
    // that already passed the flag check fail their reservation and retry
    s->draining.store(true, std::memory_order_release);
    s->cursor.fetch_add(s->capacity + 1, std::memory_order_acq_rel);
    while (s->pending.load(std::memory_order_acquire) != 0)
        std::this_thread::yield();
    int64_t n = s->committed.load(std::memory_order_acquire);
    std::memcpy(dst_out, s->dst, n * sizeof(int32_t));
    std::memcpy(payload_out, s->payload, n * s->payload_bytes);
    s->committed.store(0, std::memory_order_release);
    s->cursor.store(0, std::memory_order_release);
    s->epoch.fetch_add(1, std::memory_order_acq_rel);
    s->draining.store(false, std::memory_order_release);
    return n;
}

void aq_stager_destroy(void* h) {
    auto* s = static_cast<Stager*>(h);
    delete[] s->dst;
    delete[] s->payload;
    delete s;
}

}  // extern "C"
