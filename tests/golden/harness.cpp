// Golden-output generator: drives the C++ reference's motion-estimation
// kernels directly so the JAX framework's motion fields can be compared
// bit-for-bit (SURVEY.md §4: golden parity with seeded determinism —
// HBMA/EBMA have no RNG, so exact comparison is possible).
//
// Links against the UNMODIFIED reference sources at /root/reference (read
// only). Protocol:
//   harness <mode> <w> <h> <levels> <range> <bw> <bh>
// reads two raw luma planes (tracked, anchor; w*h bytes each) from stdin
// and writes to stdout:
//   mode "hbma":     generic EstimateMotionHierarchical — mv field (2
//                    floats/block, x then y) then min-MAD floats
//   mode "hbma16":   EstimateMotionHierarchical16x16Sse2 (levels/bw/bh
//                    ignored: pinned to 4 levels, 16x16)
//   mode "ebma":     single-level exhaustive search
//   mode "gme":      EstimateGlobalMotionExhaustiveSearch — 2 floats + mad
// Pyramids are built with cv::buildPyramid exactly like the reference
// encoder (libs/encoder.cpp:470).

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <opencv2/imgproc.hpp>

#include "motion.hpp"

int main(int argc, char** argv) {
  if (argc < 8) {
    std::fprintf(stderr,
                 "usage: harness <mode> <w> <h> <levels> <range> <bw> <bh>\n");
    return 2;
  }
  std::string mode = argv[1];
  int w = std::atoi(argv[2]);
  int h = std::atoi(argv[3]);
  int levels = std::atoi(argv[4]);
  int range = std::atoi(argv[5]);
  int bw = std::atoi(argv[6]);
  int bh = std::atoi(argv[7]);

  cv::Mat1b tracked(h, w), anchor(h, w);
  if (std::fread(tracked.data, 1, (size_t)w * h, stdin) != (size_t)w * h)
    return 3;
  if (std::fread(anchor.data, 1, (size_t)w * h, stdin) != (size_t)w * h)
    return 3;

  if (mode == "gme") {
    Vec2f gm;
    float mad;
    EstimateGlobalMotionExhaustiveSearch(tracked.data, anchor.data, w, h,
                                         range, &gm, &mad);
    std::fwrite(&gm, sizeof(gm), 1, stdout);
    std::fwrite(&mad, sizeof(mad), 1, stdout);
    return 0;
  }

  if (mode == "hbma16") {
    levels = 4;
    bw = bh = 16;
  }

  std::vector<cv::Mat1b> tpyr, apyr;
  cv::buildPyramid(tracked, tpyr, levels - 1);
  cv::buildPyramid(anchor, apyr, levels - 1);
  std::vector<const uchar*> tdata, adata;
  for (auto& m : tpyr) tdata.push_back(m.data);
  for (auto& m : apyr) adata.push_back(m.data);

  int mfw = w / bw, mfh = h / bh;
  std::vector<Vec2f> mv((size_t)mfw * mfh);
  std::vector<float> mad((size_t)mfw * mfh);

  if (mode == "hbma") {
    EstimateMotionHierarchical(tdata.data(), adata.data(), levels, w, h,
                               range, bw, bh, mv.data(), mad.data());
#ifdef __SSE2__
  } else if (mode == "hbma16") {
    EstimateMotionHierarchical16x16Sse2(tdata.data(), adata.data(), w, h,
                                        range, mv.data(), mad.data());
#endif
  } else if (mode == "ebma") {
    EstimateMotionExhaustiveSearch(tracked.data, anchor.data, w, h, range,
                                   bw, bh, mv.data(), mad.data());
  } else {
    std::fprintf(stderr, "unknown mode %s\n", mode.c_str());
    return 2;
  }

  std::fwrite(mv.data(), sizeof(Vec2f), mv.size(), stdout);
  std::fwrite(mad.data(), sizeof(float), mad.size(), stdout);
  return 0;
}
