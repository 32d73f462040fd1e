// mxnet_tpu_torch's copy of mxnet_tpu/native/engine.cc: the same code with its C
// symbols prefixed MXT (not MXTPU), so both packages' libraries can be
// loaded into one process.
//
// Host-side dependency engine.
//
// Semantics match the reference engine's observable contract
// (reference include/mxnet/engine.h:75-229, src/engine/threaded_engine.h:44-394):
//   * variables carry FIFO dependency queues; reads on a var may run
//     concurrently, a write excludes everything and serializes in push order;
//   * ops declare const (read) and mutable (write) var sets and run once all
//     grants arrive;
//   * WaitForVar blocks until everything pushed so far that touches the var
//     completed; WaitForAll drains the engine;
//   * variable deletion is itself a dependency-ordered op.
//
// The implementation is new: a single ready-queue thread pool (host work is
// IO/callback bound — device-side scheduling belongs to XLA, so the
// reference's per-device pools/stream manager have no analog here), grant
// bookkeeping via per-var deques, and an inline "naive" mode that runs ops
// synchronously on the pusher thread for debugging
// (reference src/engine/naive_engine.cc:16-198).
#include "mxt.h"

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace mxt {

inline int64_t NowMicros() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Opr;

// Per-variable dependency queue.  Protected by its own mutex; grant
// transitions happen under the lock, op scheduling happens outside it.
struct Var {
  struct Block {
    Opr* opr;
    bool write;
  };
  std::mutex mu;
  std::deque<Block> queue;
  int running_reads = 0;
  bool write_granted = false;
  bool to_delete = false;
  uint64_t version = 0;
};

struct Opr {
  std::function<void()> fn;
  std::vector<Var*> const_vars;
  std::vector<Var*> mutable_vars;
  std::atomic<int> wait{0};
  int priority = 0;
  std::string name;
  int64_t push_time_us = 0;
};

struct ProfileEvent {
  std::string name;
  int64_t start_us;
  int64_t end_us;
  uint64_t tid;
};

class Engine {
 public:
  Engine(int engine_type, int num_workers)
      : naive_(engine_type == 0) {
    if (!naive_) {
      if (num_workers <= 0) {
        // Host work is IO/callback bound — keep a floor above core count.
        num_workers = static_cast<int>(std::thread::hardware_concurrency());
        if (num_workers < 4) num_workers = 4;
      }
      for (int i = 0; i < num_workers; ++i) {
        workers_.emplace_back([this] { this->WorkerLoop(); });
      }
    }
  }

  ~Engine() { Shutdown(); }

  void Shutdown() {
    {
      std::unique_lock<std::mutex> lk(ready_mu_);
      if (stop_) return;
      WaitForAllLocked(lk);
      stop_ = true;
      ready_cv_.notify_all();
    }
    for (auto& t : workers_) t.join();
    workers_.clear();
    std::lock_guard<std::mutex> lk(vars_mu_);
    for (auto& kv : vars_) delete kv.second;
    vars_.clear();
  }

  uint64_t NewVar() {
    std::lock_guard<std::mutex> lk(vars_mu_);
    uint64_t id = next_var_id_++;
    vars_[id] = new Var();
    return id;
  }

  Var* FindVar(uint64_t id) {
    std::lock_guard<std::mutex> lk(vars_mu_);
    auto it = vars_.find(id);
    return it == vars_.end() ? nullptr : it->second;
  }

  void DeleteVar(uint64_t id) {
    Var* v = FindVar(id);
    if (v == nullptr) return;
    // Dependency-safe: deletion is a write op on the var; the var object is
    // reclaimed after every already-pushed op on it completed (reference
    // Engine::DeleteVariable contract, include/mxnet/engine.h:146-155).
    Push([this, id, v] {
      {
        std::lock_guard<std::mutex> lk(vars_mu_);
        vars_.erase(id);
      }
      v->to_delete = true;
    },
         {}, {v}, 0, "DeleteVariable");
  }

  int PushAsync(mxt_engine_cb cb, void* payload,
                const uint64_t* const_ids, int n_const,
                const uint64_t* mutable_ids, int n_mutable, int priority,
                const char* name) {
    std::vector<Var*> cvars, mvars;
    cvars.reserve(n_const);
    mvars.reserve(n_mutable);
    for (int i = 0; i < n_const; ++i) {
      Var* v = FindVar(const_ids[i]);
      if (v == nullptr) return Fail("unknown const var");
      cvars.push_back(v);
    }
    for (int i = 0; i < n_mutable; ++i) {
      Var* v = FindVar(mutable_ids[i]);
      if (v == nullptr) return Fail("unknown mutable var");
      mvars.push_back(v);
    }
    // Reject duplicates (reference ThreadedEngine::CheckDuplicate,
    // src/engine/threaded_engine.h:351).
    for (Var* c : cvars)
      for (Var* m : mvars)
        if (c == m) return Fail("var appears in both const and mutable list");
    for (size_t i = 0; i < mvars.size(); ++i)
      for (size_t j = i + 1; j < mvars.size(); ++j)
        if (mvars[i] == mvars[j]) return Fail("duplicate mutable var");
    for (size_t i = 0; i < cvars.size(); ++i)
      for (size_t j = i + 1; j < cvars.size(); ++j)
        if (cvars[i] == cvars[j]) return Fail("duplicate const var");
    Push([cb, payload] { cb(payload); }, std::move(cvars), std::move(mvars),
         priority, name ? name : "");
    return 0;
  }

  void Push(std::function<void()> fn, std::vector<Var*> cvars,
            std::vector<Var*> mvars, int priority, std::string name) {
    Opr* op = new Opr();
    op->fn = std::move(fn);
    op->const_vars = std::move(cvars);
    op->mutable_vars = std::move(mvars);
    op->priority = priority;
    op->name = std::move(name);
    op->push_time_us = NowMicros();
    {
      std::lock_guard<std::mutex> lk(ready_mu_);
      ++pending_;
    }
    // +1 guard so the op cannot fire while we are still appending deps.
    op->wait.store(1 + static_cast<int>(op->const_vars.size() +
                                        op->mutable_vars.size()),
                   std::memory_order_relaxed);
    for (Var* v : op->const_vars) AppendDep(v, op, /*write=*/false);
    for (Var* v : op->mutable_vars) AppendDep(v, op, /*write=*/true);
    OnDepGranted(op);  // release the guard
  }

  void WaitForVar(uint64_t id) {
    Var* v = FindVar(id);
    if (v == nullptr) return;
    std::mutex done_mu;
    std::condition_variable done_cv;
    bool done = false;
    Push([&] {
      std::lock_guard<std::mutex> lk(done_mu);
      done = true;
      done_cv.notify_all();
    },
         {v}, {}, 1 << 20, "WaitForVar");
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [&] { return done; });
  }

  void WaitForAll() {
    std::unique_lock<std::mutex> lk(ready_mu_);
    WaitForAllLocked(lk);
  }

  int NumPending() {
    std::lock_guard<std::mutex> lk(ready_mu_);
    return pending_;
  }

  void SetProfilerState(int state) {
    std::lock_guard<std::mutex> lk(prof_mu_);
    profiling_ = state != 0;
  }

  static std::string JsonEscape(const std::string& s) {
    std::string out;
    out.reserve(s.size());
    for (char c : s) {
      if (c == '"' || c == '\\') {
        out += '\\';
        out += c;
      } else if (static_cast<unsigned char>(c) < 0x20) {
        char buf[8];
        snprintf(buf, sizeof(buf), "\\u%04x", c);
        out += buf;
      } else {
        out += c;
      }
    }
    return out;
  }

  // Chrome traceEvents JSON (reference src/engine/profiler.cc:134-216).
  char* DumpProfile() {
    std::ostringstream os;
    os << "{\n  \"traceEvents\": [\n";
    {
      std::lock_guard<std::mutex> lk(prof_mu_);
      for (size_t i = 0; i < events_.size(); ++i) {
        ProfileEvent e = events_[i];
        e.name = JsonEscape(e.name);
        if (i) os << ",\n";
        os << "    {\"name\": \"" << e.name
           << "\", \"cat\": \"operator\", \"ph\": \"B\", \"ts\": "
           << e.start_us << ", \"pid\": 0, \"tid\": " << e.tid << "},\n";
        os << "    {\"name\": \"" << e.name
           << "\", \"cat\": \"operator\", \"ph\": \"E\", \"ts\": " << e.end_us
           << ", \"pid\": 0, \"tid\": " << e.tid << "}";
      }
    }
    os << "\n  ],\n  \"displayTimeUnit\": \"ms\"\n}\n";
    std::string s = os.str();
    char* out = static_cast<char*>(malloc(s.size() + 1));
    memcpy(out, s.c_str(), s.size() + 1);
    return out;
  }

  const char* LastError() {
    std::lock_guard<std::mutex> lk(err_mu_);
    return last_error_.c_str();
  }

 private:
  int Fail(const char* msg) {
    std::lock_guard<std::mutex> lk(err_mu_);
    last_error_ = msg;
    return -1;
  }

  void AppendDep(Var* v, Opr* op, bool write) {
    bool grant = false;
    {
      std::lock_guard<std::mutex> lk(v->mu);
      if (write) {
        if (v->queue.empty() && v->running_reads == 0 && !v->write_granted) {
          v->write_granted = true;
          grant = true;
        } else {
          v->queue.push_back({op, true});
        }
      } else {
        if (v->queue.empty() && !v->write_granted) {
          ++v->running_reads;
          grant = true;
        } else {
          v->queue.push_back({op, false});
        }
      }
    }
    if (grant) OnDepGranted(op);
  }

  void CompleteAccess(Var* v, bool write) {
    std::vector<Opr*> granted;
    bool reclaim = false;
    {
      std::lock_guard<std::mutex> lk(v->mu);
      if (write) {
        v->write_granted = false;
        ++v->version;
      } else {
        --v->running_reads;
      }
      // Grant queue heads: one write, or a maximal run of reads.
      while (!v->queue.empty()) {
        Var::Block& b = v->queue.front();
        if (b.write) {
          if (v->running_reads == 0 && !v->write_granted) {
            v->write_granted = true;
            granted.push_back(b.opr);
            v->queue.pop_front();
          }
          break;
        }
        if (v->write_granted) break;
        ++v->running_reads;
        granted.push_back(b.opr);
        v->queue.pop_front();
      }
      reclaim = v->to_delete && v->queue.empty() && v->running_reads == 0 &&
                !v->write_granted;
    }
    for (Opr* op : granted) OnDepGranted(op);
    if (reclaim) delete v;
  }

  void OnDepGranted(Opr* op) {
    if (op->wait.fetch_sub(1, std::memory_order_acq_rel) == 1) Schedule(op);
  }

  void Schedule(Opr* op) {
    if (naive_) {
      ExecuteOpr(op);
    } else {
      std::lock_guard<std::mutex> lk(ready_mu_);
      ready_.push(op);
      ready_cv_.notify_one();
    }
  }

  void ExecuteOpr(Opr* op) {
    int64_t start = profiling_ ? NowMicros() : 0;
    op->fn();
    if (profiling_) {
      ProfileEvent e;
      e.name = op->name.empty() ? "op" : op->name;
      e.start_us = start;
      e.end_us = NowMicros();
      e.tid = std::hash<std::thread::id>()(std::this_thread::get_id());
      std::lock_guard<std::mutex> lk(prof_mu_);
      events_.push_back(std::move(e));
    }
    for (Var* v : op->const_vars) CompleteAccess(v, false);
    for (Var* v : op->mutable_vars) CompleteAccess(v, true);
    delete op;
    {
      std::lock_guard<std::mutex> lk(ready_mu_);
      --pending_;
      if (pending_ == 0) all_done_cv_.notify_all();
    }
  }

  void WorkerLoop() {
    for (;;) {
      Opr* op = nullptr;
      {
        std::unique_lock<std::mutex> lk(ready_mu_);
        ready_cv_.wait(lk, [this] { return stop_ || !ready_.empty(); });
        if (stop_ && ready_.empty()) return;
        op = ready_.top();
        ready_.pop();
      }
      ExecuteOpr(op);
    }
  }

  void WaitForAllLocked(std::unique_lock<std::mutex>& lk) {
    all_done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

  struct OprLess {
    bool operator()(const Opr* a, const Opr* b) const {
      if (a->priority != b->priority) return a->priority < b->priority;
      return a->push_time_us > b->push_time_us;  // FIFO within priority
    }
  };

  bool naive_;
  bool stop_ = false;
  int pending_ = 0;
  std::mutex ready_mu_;
  std::condition_variable ready_cv_;
  std::condition_variable all_done_cv_;
  std::priority_queue<Opr*, std::vector<Opr*>, OprLess> ready_;
  std::vector<std::thread> workers_;

  std::mutex vars_mu_;
  std::unordered_map<uint64_t, Var*> vars_;
  uint64_t next_var_id_ = 1;

  std::mutex prof_mu_;
  std::atomic<bool> profiling_{false};
  std::vector<ProfileEvent> events_;

  std::mutex err_mu_;
  std::string last_error_;
};

}  // namespace mxt

extern "C" {

void* MXTEngineCreate(int engine_type, int num_workers) {
  return new mxt::Engine(engine_type, num_workers);
}

void MXTEngineShutdown(void* handle) {
  delete static_cast<mxt::Engine*>(handle);
}

uint64_t MXTEngineNewVar(void* handle) {
  return static_cast<mxt::Engine*>(handle)->NewVar();
}

void MXTEngineDeleteVar(void* handle, uint64_t var) {
  static_cast<mxt::Engine*>(handle)->DeleteVar(var);
}

int MXTEnginePushAsync(void* handle, mxt_engine_cb cb, void* payload,
                         const uint64_t* const_vars, int n_const,
                         const uint64_t* mutable_vars, int n_mutable,
                         int priority, const char* opr_name) {
  return static_cast<mxt::Engine*>(handle)->PushAsync(
      cb, payload, const_vars, n_const, mutable_vars, n_mutable, priority,
      opr_name);
}

void MXTEngineWaitForVar(void* handle, uint64_t var) {
  static_cast<mxt::Engine*>(handle)->WaitForVar(var);
}

void MXTEngineWaitForAll(void* handle) {
  static_cast<mxt::Engine*>(handle)->WaitForAll();
}

int MXTEngineNumPending(void* handle) {
  return static_cast<mxt::Engine*>(handle)->NumPending();
}

const char* MXTEngineLastError(void* handle) {
  return static_cast<mxt::Engine*>(handle)->LastError();
}

void MXTProfilerSetState(void* handle, int state) {
  static_cast<mxt::Engine*>(handle)->SetProfilerState(state);
}

char* MXTProfilerDump(void* handle) {
  return static_cast<mxt::Engine*>(handle)->DumpProfile();
}

void MXTFree(void* ptr) { free(ptr); }

}  // extern "C"
