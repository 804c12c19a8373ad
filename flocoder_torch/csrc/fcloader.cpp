// fcloader — native latent-shard reader of flocoder_torch's data pipeline,
// the port's own copy of the C++ gather beside the JAX package.
//
// The pre-encode pass can write one packed shard per split
// (flocoder_torch/data/shard.py) instead of one .npy per latent, and this
// library serves batches from it:
//
//   - the shard is mmap'd once (no per-sample open/parse syscalls)
//   - a batch is one multithreaded gather: records are memcpy'd row-wise
//     into a caller-provided buffer, with threads touching disjoint
//     output ranges (no locks)
//   - optional async prefetch: fcs_gather_async starts the gather on a
//     worker pool; fcs_wait blocks until the ticket completes.
//
// Shard layout (written by shard.py's ShardWriter):
//   magic "FCS1" | u32 json_len | header json | i32 labels[n] |
//   payload records (record_bytes each, contiguous)
//
// Built at first use by flocoder_torch/ops/kernels/build.py
// (build_host_library): g++ -O3 -shared -fPIC -pthread -std=c++17.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Shard {
    int fd = -1;
    const uint8_t* base = nullptr;
    size_t file_size = 0;
    int64_t n = 0;
    int64_t record_bytes = 0;
    const int32_t* labels = nullptr;
    const uint8_t* payload = nullptr;
};

struct Task {
    const Shard* shard;
    std::vector<int64_t> indices;
    uint8_t* out;
    int32_t* labels_out;
    std::atomic<int>* remaining;   // chunks left
    std::atomic<int>* done_flag;   // set to 1 when all chunks finish
};

class Pool {
  public:
    explicit Pool(int n_threads) {
        for (int i = 0; i < n_threads; ++i)
            workers_.emplace_back([this] { loop(); });
    }
    ~Pool() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& w : workers_) w.join();
    }
    void submit(std::function<void()> fn) {
        {
            std::lock_guard<std::mutex> lk(mu_);
            q_.push(std::move(fn));
        }
        cv_.notify_one();
    }

  private:
    void loop() {
        for (;;) {
            std::function<void()> fn;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
                if (stop_ && q_.empty()) return;
                fn = std::move(q_.front());
                q_.pop();
            }
            fn();
        }
    }
    std::mutex mu_;
    std::condition_variable cv_;
    std::queue<std::function<void()>> q_;
    std::vector<std::thread> workers_;
    bool stop_ = false;
};

Pool& pool() {
    static Pool p(std::max(2u, std::thread::hardware_concurrency()));
    return p;
}

struct Ticket {
    std::atomic<int> remaining{0};
    std::atomic<int> done{0};
    std::mutex mu;
    std::condition_variable cv;
};

void gather_range(const Shard* s, const int64_t* idx, int64_t lo, int64_t hi,
                  uint8_t* out, int32_t* labels_out) {
    const int64_t rb = s->record_bytes;
    for (int64_t i = lo; i < hi; ++i) {
        const int64_t j = idx[i];
        std::memcpy(out + i * rb, s->payload + j * rb, rb);
        if (labels_out) labels_out[i] = s->labels ? s->labels[j] : 0;
    }
}

}  // namespace

extern "C" {

void* fcs_open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
    void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) { ::close(fd); return nullptr; }
    const uint8_t* p = static_cast<const uint8_t*>(base);
    if (st.st_size < 8 || std::memcmp(p, "FCS1", 4) != 0) {
        munmap(base, st.st_size); ::close(fd); return nullptr;
    }
    uint32_t json_len;
    std::memcpy(&json_len, p + 4, 4);
    std::string header(reinterpret_cast<const char*>(p + 8), json_len);

    // minimal json field extraction: "n": <int>, "record_bytes": <int>
    auto grab = [&header](const char* key) -> int64_t {
        auto pos = header.find(key);
        if (pos == std::string::npos) return -1;
        pos = header.find(':', pos);
        return std::strtoll(header.c_str() + pos + 1, nullptr, 10);
    };
    auto* s = new Shard();
    s->fd = fd;
    s->base = p;
    s->file_size = st.st_size;
    s->n = grab("\"n\"");
    s->record_bytes = grab("\"record_bytes\"");
    if (s->n <= 0 || s->record_bytes <= 0) { delete s; return nullptr; }
    const uint8_t* cursor = p + 8 + json_len;
    s->labels = reinterpret_cast<const int32_t*>(cursor);
    s->payload = cursor + s->n * sizeof(int32_t);
    return s;
}

int64_t fcs_count(void* handle) {
    return handle ? static_cast<Shard*>(handle)->n : -1;
}

int64_t fcs_record_bytes(void* handle) {
    return handle ? static_cast<Shard*>(handle)->record_bytes : -1;
}

// Synchronous multithreaded gather.
void fcs_gather(void* handle, const int64_t* indices, int64_t count,
                uint8_t* out, int32_t* labels_out, int n_threads) {
    auto* s = static_cast<Shard*>(handle);
    if (!s || count <= 0) return;
    if (n_threads <= 1 || count < 64) {
        gather_range(s, indices, 0, count, out, labels_out);
        return;
    }
    const int chunks = std::min<int64_t>(n_threads, count);
    std::vector<std::thread> ts;
    const int64_t per = (count + chunks - 1) / chunks;
    for (int c = 0; c < chunks; ++c) {
        const int64_t lo = c * per;
        const int64_t hi = std::min<int64_t>(lo + per, count);
        if (lo >= hi) break;
        ts.emplace_back(gather_range, s, indices, lo, hi, out, labels_out);
    }
    for (auto& t : ts) t.join();
}

// Async gather: returns a ticket to wait on; worker pool does the copies.
void* fcs_gather_async(void* handle, const int64_t* indices, int64_t count,
                       uint8_t* out, int32_t* labels_out) {
    auto* s = static_cast<Shard*>(handle);
    auto* t = new Ticket();
    if (!s || count <= 0) { t->done.store(1); return t; }
    const int chunks = 4;
    const int64_t per = (count + chunks - 1) / chunks;
    std::vector<int64_t> idx(indices, indices + count);
    auto shared_idx = std::make_shared<std::vector<int64_t>>(std::move(idx));
    int actual = 0;
    for (int c = 0; c < chunks; ++c)
        if (c * per < count) ++actual;
    t->remaining.store(actual);
    for (int c = 0; c < actual; ++c) {
        const int64_t lo = c * per;
        const int64_t hi = std::min<int64_t>(lo + per, count);
        pool().submit([s, shared_idx, lo, hi, out, labels_out, t] {
            gather_range(s, shared_idx->data(), lo, hi, out, labels_out);
            if (t->remaining.fetch_sub(1) == 1) {
                {
                    std::lock_guard<std::mutex> lk(t->mu);
                    t->done.store(1);
                }
                t->cv.notify_all();
            }
        });
    }
    return t;
}

void fcs_wait(void* ticket) {
    auto* t = static_cast<Ticket*>(ticket);
    if (!t) return;
    std::unique_lock<std::mutex> lk(t->mu);
    t->cv.wait(lk, [t] { return t->done.load() != 0; });
    lk.unlock();
    delete t;
}

void fcs_close(void* handle) {
    auto* s = static_cast<Shard*>(handle);
    if (!s) return;
    munmap(const_cast<uint8_t*>(s->base), s->file_size);
    ::close(s->fd);
    delete s;
}

}  // extern "C"
