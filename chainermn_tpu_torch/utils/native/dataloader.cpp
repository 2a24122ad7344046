// Native data-loader core: prefetching batch assembly.
//
// The host side of the input pipeline (chainermn_tpu_torch.dataset.
// NativeBatchIterator): it gathers example rows into contiguous batch
// buffers with a thread pool over a ring of reusable buffers, off the
// Python GIL, so the next batch is ready before the step asks for it.
// Python drives it through a small C ABI with ctypes.  A copy of the JAX
// package's engine (chainermn_tpu/utils/native/dataloader.cpp).
//
// Model: one Loader per dataset array; jobs are index lists; each job
// fills one ring buffer with data[indices[i]] rows by parallel memcpy.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Job {
    std::vector<int64_t> indices;
    int buffer_id;
};

struct Loader {
    const uint8_t* data = nullptr;
    size_t n_rows = 0;
    size_t row_bytes = 0;
    size_t max_batch = 0;
    int n_buffers = 0;

    // Ring slots.  `buffers` are raw slot pointers; when the caller
    // supplies the ring memory (the Python binding passes a numpy-owned
    // block), `owned` stays empty and destroy() never frees the slots —
    // so a consumer-held view can never dangle, whatever its lifetime.
    std::vector<uint8_t*> buffers;
    std::vector<std::vector<uint8_t>> owned;
    std::vector<size_t> buffer_rows;  // rows filled per buffer

    // free buffer pool / pending jobs / completed buffers
    std::deque<int> free_buffers;
    std::deque<Job> pending;
    std::deque<int> completed;

    std::mutex mu;
    std::condition_variable cv_free;      // buffer became free
    std::condition_variable cv_pending;   // job arrived
    std::condition_variable cv_done;      // batch completed

    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};
    int n_threads = 1;

    // intra-batch parallel gather state.  `current` may only be
    // (re)assigned under gmu AND with active_gatherers == 0: helpers
    // read it lock-free inside gather_rows, so reassigning while one is
    // still copying is a use-after-move on the indices vector (a real
    // crash seen as a flaky suite segfault).  `epoch` stops a helper
    // that finished its chunks early from re-entering the same job in a
    // spin while `gathering` is still up.
    std::mutex gmu;
    std::condition_variable cv_gather;
    Job current;
    uint64_t epoch = 0;               // guarded by gmu
    std::atomic<int> active_gatherers{0};
    std::atomic<size_t> next_row{0};
    std::atomic<size_t> rows_done{0};
    std::atomic<bool> gathering{false};
};

void gather_rows(Loader* L) {
    // workers cooperatively pull row ranges of the current job
    const size_t chunk = 64;
    uint8_t* dst = L->buffers[L->current.buffer_id];
    const size_t n = L->current.indices.size();
    for (;;) {
        size_t start = L->next_row.fetch_add(chunk);
        if (start >= n) break;
        size_t end = start + chunk < n ? start + chunk : n;
        for (size_t i = start; i < end; ++i) {
            int64_t row = L->current.indices[i];
            std::memcpy(dst + i * L->row_bytes,
                        L->data + static_cast<size_t>(row) * L->row_bytes,
                        L->row_bytes);
        }
        L->rows_done.fetch_add(end - start);
    }
}

void worker_main(Loader* L, bool leader) {
    uint64_t last_epoch = 0;  // helpers: last job generation gathered
    for (;;) {
        if (leader) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(L->mu);
                L->cv_pending.wait(lk, [&] {
                    return L->stop.load() || !L->pending.empty();
                });
                if (L->stop.load()) break;
                job = std::move(L->pending.front());
                L->pending.pop_front();
            }
            {
                // helpers from the PREVIOUS job must be fully out of
                // gather_rows before `current` is reassigned (they read
                // it lock-free)
                std::unique_lock<std::mutex> g(L->gmu);
                L->cv_gather.wait(g, [&] {
                    return L->stop.load() ||
                           L->active_gatherers.load() == 0;
                });
                if (L->stop.load()) break;
                L->current = std::move(job);
                L->epoch++;
                L->next_row.store(0);
                L->rows_done.store(0);
                L->gathering.store(true);
            }
            L->cv_gather.notify_all();
            gather_rows(L);
            // wait until all rows are in (helpers may still be copying)
            while (L->rows_done.load() < L->current.indices.size()) {
                std::this_thread::yield();
                if (L->stop.load()) return;
            }
            {
                std::lock_guard<std::mutex> lk(L->mu);
                L->gathering.store(false);
                L->buffer_rows[L->current.buffer_id] =
                    L->current.indices.size();
                L->completed.push_back(L->current.buffer_id);
            }
            L->cv_done.notify_all();
        } else {
            {
                std::unique_lock<std::mutex> lk(L->gmu);
                L->cv_gather.wait(lk, [&] {
                    return L->stop.load() ||
                           (L->gathering.load() &&
                            L->epoch != last_epoch);
                });
                if (L->stop.load()) break;
                last_epoch = L->epoch;
                L->active_gatherers.fetch_add(1);
            }
            gather_rows(L);
            {
                std::lock_guard<std::mutex> lk(L->gmu);
                L->active_gatherers.fetch_sub(1);
            }
            L->cv_gather.notify_all();  // leader may wait for idle
        }
    }
}

}  // namespace

extern "C" {

// `ring`: optional caller-owned slot memory (n_buffers contiguous slots
// of max_batch*row_bytes each).  NULL = loader-allocated (freed on
// destroy; callers must then drop every view before destroy).
void* loader_create(const void* data, int64_t n_rows, int64_t row_bytes,
                    int64_t max_batch, int n_buffers, int n_threads,
                    void* ring) {
    Loader* L = new Loader();
    L->data = static_cast<const uint8_t*>(data);
    L->n_rows = static_cast<size_t>(n_rows);
    L->row_bytes = static_cast<size_t>(row_bytes);
    L->max_batch = static_cast<size_t>(max_batch);
    L->n_buffers = n_buffers;
    L->n_threads = n_threads > 0 ? n_threads : 1;
    L->buffers.resize(n_buffers);
    L->buffer_rows.resize(n_buffers, 0);
    const size_t slot_bytes = L->max_batch * L->row_bytes;
    if (ring != nullptr) {
        uint8_t* base = static_cast<uint8_t*>(ring);
        for (int i = 0; i < n_buffers; ++i)
            L->buffers[i] = base + static_cast<size_t>(i) * slot_bytes;
    } else {
        L->owned.resize(n_buffers);
        for (int i = 0; i < n_buffers; ++i) {
            L->owned[i].resize(slot_bytes);
            L->buffers[i] = L->owned[i].data();
        }
    }
    for (int i = 0; i < n_buffers; ++i)
        L->free_buffers.push_back(i);
    L->workers.emplace_back(worker_main, L, true);
    for (int t = 1; t < L->n_threads; ++t)
        L->workers.emplace_back(worker_main, L, false);
    return L;
}

// Enqueue a gather job. Blocks if no ring buffer is free (backpressure).
// Returns 0 on success, -1 on invalid arguments.
int loader_submit(void* handle, const int64_t* indices, int64_t n) {
    Loader* L = static_cast<Loader*>(handle);
    if (n < 0 || static_cast<size_t>(n) > L->max_batch) return -1;
    for (int64_t i = 0; i < n; ++i)
        if (indices[i] < 0 ||
            static_cast<size_t>(indices[i]) >= L->n_rows) return -1;
    Job job;
    job.indices.assign(indices, indices + n);
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_free.wait(lk, [&] {
            return L->stop.load() || !L->free_buffers.empty();
        });
        if (L->stop.load()) return -1;
        job.buffer_id = L->free_buffers.front();
        L->free_buffers.pop_front();
        L->pending.push_back(std::move(job));
    }
    L->cv_pending.notify_all();
    return 0;
}

// Block until a completed batch is available; returns buffer id and
// writes the row count + buffer pointer.
int loader_next(void* handle, void** out_ptr, int64_t* out_rows) {
    Loader* L = static_cast<Loader*>(handle);
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_done.wait(lk, [&] {
        return L->stop.load() || !L->completed.empty();
    });
    if (L->stop.load() && L->completed.empty()) return -1;
    int id = L->completed.front();
    L->completed.pop_front();
    *out_ptr = L->buffers[id];
    *out_rows = static_cast<int64_t>(L->buffer_rows[id]);
    return id;
}

// Return a buffer to the pool once its contents have been consumed.
void loader_release(void* handle, int buffer_id) {
    Loader* L = static_cast<Loader*>(handle);
    {
        std::lock_guard<std::mutex> lk(L->mu);
        L->free_buffers.push_back(buffer_id);
    }
    L->cv_free.notify_all();
}

void loader_destroy(void* handle) {
    Loader* L = static_cast<Loader*>(handle);
    // store stop while holding each CV's mutex: a bare store+notify can
    // land between a waiter's predicate check and its sleep (the waiter
    // holds the mutex there, but a notifier that never takes it can
    // slip into that window) — the wakeup is lost and join() hangs
    {
        std::lock_guard<std::mutex> lk(L->mu);
        L->stop.store(true);
    }
    {
        std::lock_guard<std::mutex> g(L->gmu);
    }
    L->cv_pending.notify_all();
    L->cv_gather.notify_all();
    L->cv_free.notify_all();
    L->cv_done.notify_all();
    for (auto& t : L->workers) t.join();
    delete L;
}

}  // extern "C"
