// Native core of the KITTI object AP evaluator (a copy of the JAX package's
// csrc/kitti_eval.cpp, kept by the PyTorch port as its own source).
//
// The reference accelerates its matching loops with numba(+numba.cuda)
// (visualDet3D/evaluator/kitti/eval.py:178-357). The Python matcher of
// visualdet3d_tpu_torch/evaluator/kitti_object/eval.py (compute_statistics)
// is the behavioural source of truth; this C++ core reproduces
// compute_statistics and the fused per-threshold accumulation for speed on
// full KITTI splits, and is loaded via ctypes (no pybind dependency).
//
// Built at first use with the host C++ compiler by ops/kernel_build.py
// (load_host('kitti_eval')) into visualdet3d_tpu_torch/build/. A failed
// build raises: the evaluator never falls back to the Python matcher on its
// own.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kNoDetection = -10000000.0;

// Axis-aligned overlap with criterion 0 (intersection / area_a), used for
// the DontCare suppression test (reference eval.py:93-120).
inline double box_overlap_crit0(const double* a, const double* b) {
  const double iw = std::min(a[2], b[2]) - std::max(a[0], b[0]);
  if (iw <= 0) return 0.0;
  const double ih = std::min(a[3], b[3]) - std::max(a[1], b[1]);
  if (ih <= 0) return 0.0;
  const double area_a = (a[2] - a[0]) * (a[3] - a[1]);
  return iw * ih / area_a;
}

struct Stats {
  int tp = 0;
  int fp = 0;
  int fn = 0;
  double similarity = 0.0;
};

// Exact port of compute_statistics (evaluator/kitti_object/eval.py:
// compute_statistics) with compute_fp semantics.
Stats compute_statistics(const double* overlaps,  // [dt, gt] row-major
                         const double* gt_datas,  // [gt, 5]
                         const double* dt_datas,  // [dt, 6]
                         const int64_t* ignored_gt, const int64_t* ignored_det,
                         const double* dc_bboxes, int num_dc, int gt_size,
                         int det_size, int metric, double min_overlap,
                         double thresh, bool compute_fp, bool compute_aos,
                         std::vector<double>* matched_thresholds) {
  Stats out;
  std::vector<char> assigned(det_size, 0);
  std::vector<char> ignored_threshold(det_size, 0);
  if (compute_fp) {
    for (int j = 0; j < det_size; ++j) {
      if (dt_datas[j * 6 + 5] < thresh) ignored_threshold[j] = 1;
    }
  }
  std::vector<double> delta;
  for (int i = 0; i < gt_size; ++i) {
    if (ignored_gt[i] == -1) continue;
    int det_idx = -1;
    double valid_detection = kNoDetection;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;
    for (int j = 0; j < det_size; ++j) {
      if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j]) continue;
      const double overlap = overlaps[j * gt_size + i];
      const double dt_score = dt_datas[j * 6 + 5];
      if (!compute_fp && overlap > min_overlap && dt_score > valid_detection) {
        det_idx = j;
        valid_detection = dt_score;
      } else if (compute_fp && overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap &&
                 valid_detection == kNoDetection && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }
    if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
      out.fn += 1;
    } else if (valid_detection != kNoDetection &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != kNoDetection) {
      out.tp += 1;
      if (matched_thresholds != nullptr) {
        matched_thresholds->push_back(dt_datas[det_idx * 6 + 5]);
      }
      if (compute_aos) {
        delta.push_back(gt_datas[i * 5 + 4] - dt_datas[det_idx * 6 + 4]);
      }
      assigned[det_idx] = 1;
    }
  }
  if (compute_fp) {
    for (int j = 0; j < det_size; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_threshold[j])) {
        out.fp += 1;
      }
    }
    int nstuff = 0;
    if (metric == 0 && num_dc > 0) {
      for (int i = 0; i < num_dc; ++i) {
        for (int j = 0; j < det_size; ++j) {
          if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
              ignored_threshold[j]) {
            continue;
          }
          if (box_overlap_crit0(&dt_datas[j * 6], &dc_bboxes[i * 4]) >
              min_overlap) {
            assigned[j] = 1;
            nstuff += 1;
          }
        }
      }
    }
    out.fp -= nstuff;
    if (compute_aos) {
      double sim = 0.0;
      for (double d : delta) sim += (1.0 + std::cos(d)) / 2.0;
      out.similarity = (out.tp > 0 || out.fp > 0) ? sim : -1.0;
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Pass 1: collect matched-detection scores over all images (compute_fp=false).
// Returns the count of matched thresholds written into thresholds_out
// (caller allocates >= total_gt slots).
int collect_thresholds(const double* overlaps_flat, const int* overlap_offsets,
                       const double* gt_flat, const int* gt_offsets,
                       const double* dt_flat, const int* dt_offsets,
                       const int64_t* ignored_gt_flat,
                       const int64_t* ignored_det_flat, int num_images,
                       int metric, double min_overlap, double* thresholds_out) {
  std::vector<double> matched;
  for (int i = 0; i < num_images; ++i) {
    const int gt_size = gt_offsets[i + 1] - gt_offsets[i];
    const int det_size = dt_offsets[i + 1] - dt_offsets[i];
    compute_statistics(
        overlaps_flat + overlap_offsets[i], gt_flat + gt_offsets[i] * 5,
        dt_flat + dt_offsets[i] * 6, ignored_gt_flat + gt_offsets[i],
        ignored_det_flat + dt_offsets[i], nullptr, 0, gt_size, det_size,
        metric, min_overlap, 0.0, /*compute_fp=*/false, /*compute_aos=*/false,
        &matched);
  }
  std::memcpy(thresholds_out, matched.data(), matched.size() * sizeof(double));
  return static_cast<int>(matched.size());
}

// Pass 2: accumulate [tp, fp, fn, similarity] per threshold over all images.
// pr_out: [num_thresholds, 4], zero-initialised by the caller.
void fused_statistics(const double* overlaps_flat, const int* overlap_offsets,
                      const double* gt_flat, const int* gt_offsets,
                      const double* dt_flat, const int* dt_offsets,
                      const int64_t* ignored_gt_flat,
                      const int64_t* ignored_det_flat, const double* dc_flat,
                      const int* dc_offsets, int num_images, int metric,
                      double min_overlap, const double* thresholds,
                      int num_thresholds, int compute_aos, double* pr_out) {
  for (int i = 0; i < num_images; ++i) {
    const int gt_size = gt_offsets[i + 1] - gt_offsets[i];
    const int det_size = dt_offsets[i + 1] - dt_offsets[i];
    const int num_dc = dc_offsets[i + 1] - dc_offsets[i];
    for (int t = 0; t < num_thresholds; ++t) {
      Stats s = compute_statistics(
          overlaps_flat + overlap_offsets[i], gt_flat + gt_offsets[i] * 5,
          dt_flat + dt_offsets[i] * 6, ignored_gt_flat + gt_offsets[i],
          ignored_det_flat + dt_offsets[i], dc_flat + dc_offsets[i] * 4,
          num_dc, gt_size, det_size, metric, min_overlap, thresholds[t],
          /*compute_fp=*/true, compute_aos != 0, nullptr);
      pr_out[t * 4 + 0] += s.tp;
      pr_out[t * 4 + 1] += s.fp;
      pr_out[t * 4 + 2] += s.fn;
      if (s.similarity != -1.0) pr_out[t * 4 + 3] += s.similarity;
    }
  }
}

}  // extern "C"
