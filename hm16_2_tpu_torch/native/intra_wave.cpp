// The native intra walk of a planned I slice as a CTU wavefront.
//
// dsp_core's commit_plan_frame commits every CTU of the picture in raster
// order through commit_plan_ctu.  A CTU's commit reads only what its left,
// above-left, above and above-right neighbours finished (reference samples
// and the `coded` flags that gate them, the left MPM), its bit counts start
// from fixed slice-init contexts, and its scratch is thread_local.  So the
// CTUs can be committed by several threads at once, each row after the row
// above it by two CTUs (the lag of WPP, without its CABAC context sync:
// nothing entropy-coded is carried from CTU to CTU), and the picture's
// arrays come out as the raster walk leaves them.
//
// Workers take rows in order.  A worker starts CTU (x, y) once row y - 1
// has finished min(x + 2, wc) CTUs; a row's progress is an atomic counter
// published with release and read with acquire, so that the samples and
// part-grid fields it covers are seen.  When a CTU fails, no CTU after it
// in raster order starts, the CTUs before it still run, and the call
// returns 1 + the smallest failing raster index k, as commit_plan_frame
// does.  Every CTU after k that the wavefront started then has its `coded`
// flags cleared, so that the host's re-run from k finds the state the
// raster walk leaves: what a started CTU wrote elsewhere is read only
// where `coded` says it is there, and the re-run writes it again.

#include <atomic>
#include <chrono>
#include <climits>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

typedef int (*commit_ctu_fn_t)(const void *ctx, int cx, int cy);

namespace {

struct alignas(64) Row {
  std::atomic<int> done;   // CTUs of the row committed, left to right
};

struct Wave {
  const void *ctx;
  commit_ctu_fn_t fn;
  int wc, hc;
  std::unique_ptr<Row[]> rows;
  std::vector<uint8_t> started;   // per CTU; each written by its row's worker
  alignas(64) std::atomic<int> next_row;
  alignas(64) std::atomic<int> fail;   // smallest failing raster index
  std::atomic<int64_t> wait_ns;
};

inline void cpu_relax() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#endif
}

// Blocks until row y - 1 has finished `need` CTUs, or until a failure
// before raster index idx makes the wait moot; returns the ns it waited.
int64_t wait_above(Wave *W, int y, int need, int idx) {
  const std::atomic<int> &above = W->rows[y - 1].done;
  if (above.load(std::memory_order_acquire) >= need) return 0;
  auto t0 = std::chrono::steady_clock::now();
  for (int spin = 0; above.load(std::memory_order_acquire) < need; spin++) {
    if (W->fail.load(std::memory_order_acquire) < idx) break;
    if (spin < 256)
      cpu_relax();
    else if (spin < 4096)
      std::this_thread::yield();
    else
      std::this_thread::sleep_for(std::chrono::microseconds(20));
  }
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now() - t0).count();
}

void worker(Wave *W) {
  int64_t waited = 0;
  for (;;) {
    int y = W->next_row.fetch_add(1, std::memory_order_relaxed);
    if (y >= W->hc) break;
    for (int x = 0; x < W->wc; x++) {
      int idx = y * W->wc + x;
      if (y > 0)
        waited += wait_above(W, y, x + 2 < W->wc ? x + 2 : W->wc, idx);
      if (W->fail.load(std::memory_order_acquire) < idx) break;
      W->started[idx] = 1;
      if (W->fn(W->ctx, x, y) < 0) {
        int cur = W->fail.load(std::memory_order_relaxed);
        while (idx < cur &&
               !W->fail.compare_exchange_weak(cur, idx,
                                              std::memory_order_acq_rel))
          ;
        break;
      }
      W->rows[y].done.store(x + 1, std::memory_order_release);
    }
  }
  W->wait_ns.fetch_add(waited, std::memory_order_relaxed);
}

}  // namespace

// Commits the wc x hc CTUs of a planned I slice through commit_ctu (dsp_core's
// commit_plan_ctu on ctx) on nthreads threads, the caller's among them.
// coded (row stride parts_w, ctu_parts parts a CTU side) is the picture's
// `coded` part grid.  Returns 0, or 1 + the raster index of the first CTU
// that failed; *wait_ns (when given) receives the summed ns that workers
// waited on the row above.
extern "C" int intra_wave_commit(const void *ctx, commit_ctu_fn_t commit_ctu,
                                 int wc, int hc, int nthreads,
                                 uint8_t *coded, int parts_w, int ctu_parts,
                                 int64_t *wait_ns) {
  Wave W;
  W.ctx = ctx;
  W.fn = commit_ctu;
  W.wc = wc;
  W.hc = hc;
  W.rows.reset(new Row[hc]);
  for (int y = 0; y < hc; y++) W.rows[y].done.store(0);
  W.started.assign((size_t)wc * hc, 0);
  W.next_row.store(0);
  W.fail.store(INT_MAX);
  W.wait_ns.store(0);
  std::vector<std::thread> pool;
  for (int t = 1; t < nthreads; t++) {
    try {
      pool.emplace_back(worker, &W);
    } catch (...) {
      break;   // fewer threads: rows are taken as workers free up
    }
  }
  worker(&W);
  for (auto &th : pool) th.join();
  if (wait_ns) *wait_ns = W.wait_ns.load();
  int k = W.fail.load();
  if (k == INT_MAX) return 0;
  for (int idx = k + 1; idx < wc * hc; idx++) {
    if (!W.started[idx]) continue;
    int px = (idx % wc) * ctu_parts, py = (idx / wc) * ctu_parts;
    for (int y = 0; y < ctu_parts; y++)
      memset(coded + (int64_t)(py + y) * parts_w + px, 0, (size_t)ctu_parts);
  }
  return 1 + k;
}
