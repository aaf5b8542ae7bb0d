// ps_loader — native batch-assembly kernels for the data pipeline.
//
// The hot loop of host-side batching is row gather: copying batch_size
// scattered example rows into one contiguous buffer for device transfer.
// numpy fancy indexing does this single-threaded; at ImageNet row sizes
// (224*224*3*4 ≈ 600 KB) assembling a 1024-batch is ~600 MB of memcpy per
// step — worth real threads.  ctypes releases the GIL for the call, and the
// kernel splits rows across a small thread team.
//
// The reference has no data pipeline at all (no train.py); its
// native analogue is the torch DataLoader's C++ worker pool.  This is the
// in-repo equivalent for the zero-copy numpy world.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

namespace {

void gather_span(const uint8_t* src, const int64_t* idx, size_t begin,
                 size_t end, size_t row_bytes, uint8_t* dst) {
  for (size_t i = begin; i < end; ++i) {
    std::memcpy(dst + i * row_bytes, src + static_cast<size_t>(idx[i]) * row_bytes,
                row_bytes);
  }
}

}  // namespace

extern "C" {

// dst[i] = src[idx[i]] for n_rows rows of row_bytes each, using up to
// n_threads workers.  Caller guarantees idx values are in range.
void ps_gather_rows(const uint8_t* src, const int64_t* idx, size_t n_rows,
                    size_t row_bytes, uint8_t* dst, int n_threads) {
  size_t total = n_rows * row_bytes;
  if (n_threads <= 1 || n_rows < 2 || total < (1u << 20)) {
    gather_span(src, idx, 0, n_rows, row_bytes, dst);
    return;
  }
  size_t workers = std::min<size_t>(n_threads, n_rows);
  std::vector<std::thread> team;
  team.reserve(workers);
  size_t chunk = (n_rows + workers - 1) / workers;
  for (size_t w = 0; w < workers; ++w) {
    size_t begin = w * chunk;
    size_t end = std::min(begin + chunk, n_rows);
    if (begin >= end) break;
    team.emplace_back(gather_span, src, idx, begin, end, row_bytes, dst);
  }
  for (auto& t : team) t.join();
}

}  // extern "C"
