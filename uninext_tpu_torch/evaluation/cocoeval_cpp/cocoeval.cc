// Fast COCO evaluation core — the greedy per-(image, category, area-range)
// matching loop that dominates COCOeval time.
//
// Native counterpart of the reference's COCOeval_opt
// (detectron2/layers/csrc/cocoeval/cocoeval.cpp, SURVEY N5), re-implemented
// from the published COCO matching protocol:
//   * detections visited in descending-score order
//   * ground truths ordered regular-first, ignored-last
//   * a detection may take an ignored gt only if no regular gt matched
//   * ties resolved by the best IoU seen so far (monotone threshold raise)
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// ious:        n_det x n_gt row-major, dets pre-sorted by descending score
// gt_ignore:   n_gt flags (area-range ignores), gts pre-sorted ignored-last
// thrs:        n_thr IoU thresholds
// det_match:   out, n_thr x n_det gt index or -1
// det_ignore:  out, n_thr x n_det 0/1 (matched-to-ignored or unmatched+det_ignore_mask)
// det_ignore_mask: n_det flags (det outside area range)
void coco_match(const float* ious, int n_det, int n_gt,
                const uint8_t* gt_ignore, const float* thrs, int n_thr,
                const uint8_t* det_ignore_mask,
                int64_t* det_match, uint8_t* det_ignore) {
  std::vector<uint8_t> taken(n_gt);
  for (int t = 0; t < n_thr; ++t) {
    std::fill(taken.begin(), taken.end(), 0);
    const float thr = thrs[t];
    for (int d = 0; d < n_det; ++d) {
      float best_iou = thr < 1e-10f ? 1e-10f : thr;
      int best = -1;
      for (int g = 0; g < n_gt; ++g) {
        if (taken[g]) continue;
        // dets already matched to a regular gt stop at the ignored block
        if (best > -1 && !gt_ignore[best] && gt_ignore[g]) break;
        const float v = ious[d * n_gt + g];
        if (v < best_iou) continue;
        best_iou = v;
        best = g;
      }
      const int64_t idx = (int64_t)t * n_det + d;
      if (best >= 0) {
        taken[best] = 1;
        det_match[idx] = best;
        det_ignore[idx] = gt_ignore[best];
      } else {
        det_match[idx] = -1;
        det_ignore[idx] = det_ignore_mask[d];
      }
    }
  }
}

}  // extern "C"
