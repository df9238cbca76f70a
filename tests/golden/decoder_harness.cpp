// Decoder golden-output generator: drives the C++ reference's block
// decode path (ParseBlock + DecodeBlock, libs/decoder.cpp:102-149,
// UNMODIFIED — the functions are file-static, so this TU includes the
// reference source directly) over a complete bitstream and emits the
// reconstructed padded float frames, so the JAX framework's
// dequantize + IDCT + merge can be compared block-for-block.
//
// The display tail of Decoder::operator() (gaze snapshotting, /255,
// resize, imshow — libs/decoder.cpp:151-216) is NOT exercised: gaze-rect
// geometry is unit-tested separately against the reference's
// CalcWithinFrameRectFromCenter semantics, and the reference has no
// headless output to capture. The gaze rect arrives here already in
// padded space; "gazed" uses cv::Rect::contains on the block top-left
// exactly like libs/decoder.cpp:197-201.
//
// Protocol:
//   decoder_harness <fg_step> <bg_step> <gx> <gy> <gw> <gh>
// stdin:  a complete bitstream (32-byte header + fixed-size blocks).
// stdout: frame_count frames of raw float32 (padded_h, padded_w, 3)
//         merged BGR pixels (pre-display-scaling).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "../../../reference/libs/decoder.cpp"  // unmodified reference TU

int main(int argc, char** argv) {
  if (argc < 7) {
    std::fprintf(stderr,
                 "usage: decoder_harness <fg> <bg> <gx> <gy> <gw> <gh>\n");
    return 2;
  }
  uint fg = std::atoi(argv[1]);
  uint bg = std::atoi(argv[2]);
  cv::Rect gaze(std::atoi(argv[3]), std::atoi(argv[4]), std::atoi(argv[5]),
                std::atoi(argv[6]));

  Header h{};
  if (std::fread(&h, sizeof(h), 1, stdin) != 1) return 3;
  uint pw = h.frame_w + h.frame_excess_w;
  uint ph = h.frame_h + h.frame_excess_h;
  uint bw = h.transform_block_w;
  uint bh = h.transform_block_h;
  uint block_bytes = sizeof(uint) + sizeof(float) * bw * bh * h.channel_count;

  std::vector<std::byte> raw(block_bytes);
  Block block;
  cv::Mat3f frame(ph, pw);
  cv::Mat3f decoded(bh, bw);

  for (uint f = 0; f < h.frame_count; ++f) {
    for (uint y = 0; y < ph; y += bh) {
      for (uint x = 0; x < pw; x += bw) {
        if (std::fread(raw.data(), 1, block_bytes, stdin) != block_bytes) {
          std::fprintf(stderr, "short read frame %u block (%u,%u)\n", f, y, x);
          return 3;
        }
        ParseBlock(raw, h.channel_count, bw, bh, block);
        bool gazed = gaze.contains(cv::Point2i(x, y));
        DecodeBlock(block, gazed, fg, bg, decoded);
        decoded.copyTo(frame(cv::Rect(x, y, bw, bh)));
      }
    }
    std::fwrite(frame.data, sizeof(float), (size_t)ph * pw * 3, stdout);
  }
  return 0;
}
