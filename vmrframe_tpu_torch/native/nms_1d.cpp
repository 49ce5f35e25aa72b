// 1D NMS / soft-NMS on the CPU: the C++ twin of the port's on-device
// ops/nms.py::batched_nms_1d (a copy of the JAX package's twin).
//
// Greedy max-score selection with hard suppression (method 0), linear soft
// decay (method 1: s *= 1 - iou when iou > threshold) or gaussian soft decay
// (method 2: s *= exp(-iou^2 / sigma)), stopping when the best remaining
// decayed score drops below min_score: the semantics of the ActionFormer
// upstream's compiled extension.
//
// Loaded with ctypes by vmrframe_tpu_torch/native/__init__.py, which builds
// it with g++ at first use.
//
// Build: g++ -O2 -shared -fPIC -o libnms_1d.so nms_1d.cpp

#include <cmath>
#include <cstring>
#include <vector>

namespace {

inline float iou_1d(const float* a, const float* b) {
  float inter = std::fmin(a[1], b[1]) - std::fmax(a[0], b[0]);
  if (inter < 0.f) inter = 0.f;
  float uni = (a[1] - a[0]) + (b[1] - b[0]) - inter;
  return uni > 1e-8f ? inter / uni : 0.f;
}

}  // namespace

extern "C" {

// Returns the number of kept segments (<= max_keep).
// keep_idx / keep_scores must have room for max_keep entries.
int nms_1d(const float* segs, const float* scores, int n, float iou_threshold,
           float min_score, int method, float sigma, int max_keep,
           int* keep_idx, float* keep_scores) {
  std::vector<float> s(scores, scores + n);
  std::vector<char> alive(n, 1);
  int kept = 0;
  while (kept < max_keep) {
    int best = -1;
    float best_score = -1.f;
    for (int i = 0; i < n; ++i) {
      if (alive[i] && s[i] > best_score) {
        best_score = s[i];
        best = i;
      }
    }
    if (best < 0 || best_score < min_score) break;
    keep_idx[kept] = best;
    keep_scores[kept] = best_score;
    ++kept;
    alive[best] = 0;
    const float* bseg = segs + 2 * best;
    for (int i = 0; i < n; ++i) {
      if (!alive[i]) continue;
      float ov = iou_1d(bseg, segs + 2 * i);
      if (method == 0) {  // hard
        if (ov > iou_threshold) alive[i] = 0;
      } else if (method == 1) {  // linear soft
        if (ov > iou_threshold) s[i] *= (1.f - ov);
      } else {  // gaussian soft
        s[i] *= std::exp(-(ov * ov) / sigma);
      }
    }
  }
  return kept;
}

// The batched form: B independent problems of size n each.
void nms_1d_batch(const float* segs, const float* scores, int batch, int n,
                  float iou_threshold, float min_score, int method, float sigma,
                  int max_keep, int* keep_idx, float* keep_scores,
                  int* keep_counts) {
  for (int b = 0; b < batch; ++b) {
    keep_counts[b] =
        nms_1d(segs + (size_t)b * n * 2, scores + (size_t)b * n, n,
               iou_threshold, min_score, method, sigma, max_keep,
               keep_idx + (size_t)b * max_keep, keep_scores + (size_t)b * max_keep);
  }
}

}  // extern "C"
