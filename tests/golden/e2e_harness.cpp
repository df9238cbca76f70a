// End-to-end golden-output generator: runs the C++ reference's FULL
// Encoder pipeline (libs/encoder.cpp:144-671, unmodified) on raw BGR frames
// and emits the complete bitstream, so the JAX framework's encoder output
// can be compared against the reference byte-for-byte (header + block
// types) and ulp-for-ulp (DCT coefficients).
//
// Frames are fed from stdin as properly CLONED cv::Mat3b. Note this
// deliberately avoids the reference app's own Reader
// (apps/encoder.cpp:143-145), which pushes aliasing Mat headers into the
// queue while cv::VideoCapture::read reuses its decode buffer — on this
// platform every queued frame's data is overwritten by later decodes, so
// the app encodes (mostly) the last-read frame. See ARCHITECTURE.md quirk
// E10; this harness exists to test the Encoder class, not that app bug.
//
// Protocol:
//   e2e_harness <w> <h> <frame_count> <kmeans_k> [morph_w morph_h]
// stdin: frame_count raw BGR frames, w*h*3 bytes each (row-major, BGR
//        interleaved — exactly cv::Mat3b layout).
// morph_w/morph_h default to the app's 3x3; 1x1 disables morphology so
// tiny foreground sets survive (the k-clamp regime test,
// encoder.cpp:557-559 k = min(cluster_count, fg_count)).
// stdout: the reference bitstream (Header then per-frame serialized blocks,
//         encoder.cpp:222-269,360-381).
//
// Config: the reference app's defaults (apps/encoder.cpp:28-58) with
// kmeans.cluster_count overridden; kmeans_k == 1 makes clustering
// deterministic (a single cluster regardless of cv::kmeans RNG), which
// combined with a deterministic-RANSAC clip design gives a fully
// deterministic bitstream modulo nothing (coefficients are RNG-free).
//
// Queues are sized frame_count+2 so the whole run is single-threaded and
// deterministic: push everything, signal EOS, run the Encoder, drain.

#include <cstdio>
#include <cstdlib>
#include <future>
#include <vector>

#include <opencv2/core.hpp>

#include "encoder.hpp"
#include "queue.hpp"

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr, "usage: e2e_harness <w> <h> <frame_count> <kmeans_k>\n");
    return 2;
  }
  uint w = std::atoi(argv[1]);
  uint h = std::atoi(argv[2]);
  uint n = std::atoi(argv[3]);
  uint k = std::atoi(argv[4]);
  uint morph_w = argc > 6 ? std::atoi(argv[5]) : 3;
  uint morph_h = argc > 6 ? std::atoi(argv[6]) : 3;

  EncoderConfig cfg{};
  // apps/encoder.cpp:28-58 defaults
  cfg.mv_block_w = 16;
  cfg.mv_block_h = 16;
  cfg.mv_search_range = 8;
  cfg.pyr_lvl_count = 4;
  cfg.ransac.subset_sz = 1;
  cfg.ransac.inlier_ratio = 0.5f;
  cfg.ransac.success_prob = 0.99f;
  cfg.ransac.inlier_thresh = 7.5f;
  cfg.morph_rect_w = morph_w;
  cfg.morph_rect_h = morph_h;
  cfg.kmeans.cluster_count = k;
  cfg.kmeans.attempt_count = 3;
  cfg.kmeans.max_iter_count = 10;
  cfg.kmeans.epsilon = 1;
  cfg.connected_components_connectivity = 4;
  cfg.transform_block_w = 8;
  cfg.transform_block_h = 8;

  Error err = Validate(cfg);
  if (err.code != ErrorCode::kOk) {
    std::fprintf(stderr, "config: %s\n", err.message.c_str());
    return 2;
  }

  VideoProperties props{w, h, n};

  CircularQueue<cv::Mat3b> in_queue{n + 2};
  CircularQueue<std::vector<uchar>> out_queue{2 * n + 2};

  for (uint i = 0; i < n; ++i) {
    cv::Mat3b frame(h, w);
    size_t sz = (size_t)w * h * 3;
    if (std::fread(frame.data, 1, sz, stdin) != sz) {
      std::fprintf(stderr, "short read on frame %u\n", i);
      return 3;
    }
    in_queue.Push(frame);  // each Mat owns a fresh buffer (no aliasing)
  }
  in_queue.SignalProducerIsDone();

  std::promise<void> first_read;
  first_read.set_value();

  Encoder encode{cfg, props, in_queue, first_read.get_future(), out_queue};
  encode();

  std::vector<uchar> bytes;
  while (out_queue.Pop(bytes)) {
    if (std::fwrite(bytes.data(), 1, bytes.size(), stdout) != bytes.size()) {
      std::fprintf(stderr, "short write\n");
      return 4;
    }
  }
  return 0;
}
