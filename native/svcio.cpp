// svcio — native host runtime for the svc_tpu video codec.
//
// The reference implements its host runtime in C++: a bounded circular
// queue feeding reader/writer threads (libs/queue.hpp, apps/encoder.cpp:
// 125-170) and per-frame byte serialization (libs/encoder.cpp:222-269).
// This library is the framework's native equivalent: the wire-format
// hot path (interleaving block types with per-channel coefficient planes)
// and a pipelined bitstream writer, callable from Python via ctypes.
//
// Wire format (one frame): raster scan over transform blocks of the padded
// frame; per block a raw uint32 block type followed by, per channel,
// block_h rows of block_w float32 DCT coefficients (libs/codec.hpp,
// apps/decoder.cpp:59-64).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// Serialize one encoded frame.
//   coeffs:  (channels, padded_h, padded_w) float32, C-contiguous
//   types:   (padded_h / tb_h, padded_w / tb_w) uint32 per transform block
//   out:     caller-allocated, n_blocks * (4 + 4 * tb_w * tb_h * channels)
// Returns the number of bytes written.
long long svc_serialize_frame(const float* coeffs, const uint32_t* types,
                              int channels, int padded_h, int padded_w,
                              int tb_w, int tb_h, uint8_t* out) {
  const int nbx = padded_w / tb_w;
  const int nby = padded_h / tb_h;
  const long long plane = (long long)padded_h * padded_w;
  uint8_t* p = out;

  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      const uint32_t t = types[by * nbx + bx];
      std::memcpy(p, &t, 4);
      p += 4;
      for (int c = 0; c < channels; ++c) {
        const float* src =
            coeffs + c * plane + (long long)by * tb_h * padded_w + bx * tb_w;
        for (int row = 0; row < tb_h; ++row) {
          std::memcpy(p, src + (long long)row * padded_w,
                      sizeof(float) * tb_w);
          p += sizeof(float) * tb_w;
        }
      }
    }
  }
  return p - out;
}

// Inverse of svc_serialize_frame.
long long svc_deserialize_frame(const uint8_t* data, int channels,
                                int padded_h, int padded_w, int tb_w,
                                int tb_h, uint32_t* types, float* coeffs) {
  const int nbx = padded_w / tb_w;
  const int nby = padded_h / tb_h;
  const long long plane = (long long)padded_h * padded_w;
  const uint8_t* p = data;

  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      std::memcpy(&types[by * nbx + bx], p, 4);
      p += 4;
      for (int c = 0; c < channels; ++c) {
        float* dst =
            coeffs + c * plane + (long long)by * tb_h * padded_w + bx * tb_w;
        for (int row = 0; row < tb_h; ++row) {
          std::memcpy(dst + (long long)row * padded_w, p,
                      sizeof(float) * tb_w);
          p += sizeof(float) * tb_w;
        }
      }
    }
  }
  return p - data;
}

// Serialize a frame whose coefficients are already in wire block layout
// (nby, nbx, channels, tb_h, tb_w) — the per-block payload is contiguous,
// so this is a strided memcpy interleaving the 4 type bytes.
long long svc_serialize_blocks(const float* blocks, const uint32_t* types,
                               long long n_blocks, long long block_floats,
                               uint8_t* out) {
  uint8_t* p = out;
  const long long payload = block_floats * (long long)sizeof(float);
  for (long long b = 0; b < n_blocks; ++b) {
    std::memcpy(p, &types[b], 4);
    p += 4;
    std::memcpy(p, blocks + b * block_floats, payload);
    p += payload;
  }
  return p - out;
}

// ---------------------------------------------------------------------------
// Pipelined bitstream writer: a bounded queue + writer thread, the native
// equivalent of CircularQueue<std::vector<uchar>> + the Writer functor
// (libs/queue.hpp:12-84, apps/encoder.cpp:151-170).
// ---------------------------------------------------------------------------

struct SvcWriter {
  FILE* file = nullptr;
  bool owns_file = false;
  size_t capacity = 10;  // reference queue cap (apps/encoder.cpp:172-173)
  std::deque<std::vector<uint8_t>> queue;
  std::mutex mutex;
  std::condition_variable not_full;
  std::condition_variable not_empty;
  bool done = false;
  std::atomic<bool> failed{false};
  std::thread thread;

  void run() {
    for (;;) {
      std::vector<uint8_t> chunk;
      {
        std::unique_lock<std::mutex> lock(mutex);
        not_empty.wait(lock, [&] { return !queue.empty() || done; });
        if (queue.empty()) return;  // done and drained
        chunk = std::move(queue.front());
        queue.pop_front();
      }
      not_full.notify_one();
      if (!chunk.empty() &&
          std::fwrite(chunk.data(), 1, chunk.size(), file) < chunk.size()) {
        failed.store(true);
        return;
      }
    }
  }
};

SvcWriter* svc_writer_open(const char* path, int capacity) {
  auto* w = new SvcWriter();
  if (path && path[0]) {
    w->file = std::fopen(path, "wb");
    w->owns_file = true;
    if (!w->file) {
      delete w;
      return nullptr;
    }
  } else {
    w->file = stdout;
  }
  if (capacity > 0) w->capacity = (size_t)capacity;
  w->thread = std::thread([w] { w->run(); });
  return w;
}

// Blocking push (backpressure like CircularQueue::Push, libs/queue.hpp:23).
// Returns 0 on success, -1 if the writer already failed.
int svc_writer_push(SvcWriter* w, const uint8_t* data, long long size) {
  if (w->failed.load()) return -1;
  std::vector<uint8_t> chunk(data, data + size);
  {
    std::unique_lock<std::mutex> lock(w->mutex);
    w->not_full.wait(lock, [&] {
      return w->queue.size() < w->capacity || w->failed.load();
    });
    if (w->failed.load()) return -1;
    w->queue.push_back(std::move(chunk));
  }
  w->not_empty.notify_one();
  return 0;
}

// Signal EOS, join, flush, close. Returns 0 on success, -1 on write failure.
int svc_writer_close(SvcWriter* w) {
  {
    std::unique_lock<std::mutex> lock(w->mutex);
    w->done = true;
  }
  w->not_empty.notify_one();
  if (w->thread.joinable()) w->thread.join();
  int rc = w->failed.load() ? -1 : 0;
  std::fflush(w->file);
  if (w->owns_file) std::fclose(w->file);
  delete w;
  return rc;
}

}  // extern "C"
