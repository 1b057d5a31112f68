// Reference CPU baseline harness.
//
// Compiles the reference library's ACTUAL stereo-VO hot path (core + vo
// modules from /root/reference, built unmodified by build.sh) together with
// the OpenCV consumer front-end the reference assumes its users supply
// (GFTT detection + PyrLK stereo matching and temporal tracking; the library
// itself ships no front-end — see SURVEY.md TL;DR). Times the full per-frame
// loop (front-end + RANSAC/GN pose solve), which is the same scope as the
// JAX pipeline's per-frame step, and dumps the pose chain for ATE evaluation.
//
// Usage: ref_vo <frames_dir> <n_frames> <fu> <fv> <cu> <cv> <baseline>
//   frames_dir must contain L_%06d.png / R_%06d.png rendered by bench.py.

#include <chrono>
#include <cstdio>
#include <iostream>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/video/tracking.hpp>

#include "vo/StereoVisualOdometry.h"

using namespace std;

static vector<cv::Point2f> detect(const cv::Mat& img, int max_feats) {
  vector<cv::Point2f> pts;
  cv::goodFeaturesToTrack(img, pts, max_feats, 0.01, 10);
  return pts;
}

// PyrLK correspondence img_a -> img_b; marks failures in status.
static void track(const cv::Mat& a, const cv::Mat& b,
                  const vector<cv::Point2f>& pa, vector<cv::Point2f>& pb,
                  vector<uchar>& status) {
  vector<float> err;
  if (pa.empty()) return;
  cv::calcOpticalFlowPyrLK(a, b, pa, pb, status, err, cv::Size(21, 21), 3);
}

int main(int argc, char** argv) {
  if (argc < 8) {
    fprintf(stderr, "usage: %s dir n fu fv cu cv baseline\n", argv[0]);
    return 1;
  }
  string dir = argv[1];
  int n_frames = atoi(argv[2]);
  me::StereoVisualOdometry::parameters p;
  p.fu1 = p.fu2 = atof(argv[3]);
  p.fv1 = p.fv2 = atof(argv[4]);
  p.cu1 = p.cu2 = atof(argv[5]);
  p.cv1 = p.cv2 = atof(argv[6]);
  p.baseline = atof(argv[7]);
  // defaults already match the reference: GN, 200 RANSAC iters, thr 2.0 px
  me::StereoVisualOdometry vo(p);

  char buf[512];
  auto load = [&](const char* pre, int i) {
    snprintf(buf, sizeof(buf), "%s/%s_%06d.png", dir.c_str(), pre, i);
    cv::Mat m = cv::imread(buf, cv::IMREAD_GRAYSCALE);
    if (m.empty()) { fprintf(stderr, "missing %s\n", buf); exit(2); }
    return m;
  };

  cv::Mat prev_l = load("L", 0), prev_r = load("R", 0);
  cv::Mat pose = cv::Mat::eye(4, 4, CV_64F);
  vector<cv::Mat> traj{pose.clone()};

  double total_s = 0.0;
  int ok_frames = 0;
  for (int i = 1; i < n_frames; i++) {
    cv::Mat cur_l = load("L", i), cur_r = load("R", i);
    auto t0 = chrono::steady_clock::now();

    // consumer front-end: GFTT + stereo PyrLK + temporal PyrLK (quad match)
    vector<cv::Point2f> f1 = detect(prev_l, 500);
    vector<cv::Point2f> f2, f3, f4;
    vector<uchar> s12, s13, s34;
    track(prev_l, prev_r, f1, f2, s12);
    track(prev_l, cur_l, f1, f3, s13);
    track(cur_l, cur_r, f3, f4, s34);

    vector<me::StereoOdoMatchesf> matches;
    for (size_t k = 0; k < f1.size(); k++) {
      if (!s12[k] || !s13[k] || !s34[k]) continue;
      float d1 = f1[k].x - f2[k].x, d2 = f3[k].x - f4[k].x;
      if (d1 <= 0.5f || d2 <= 0.5f) continue;                 // positive disparity
      if (fabs(f1[k].y - f2[k].y) > 2.f || fabs(f3[k].y - f4[k].y) > 2.f)
        continue;                                             // rectified epipolar
      matches.emplace_back(f1[k], f2[k], f3[k], f4[k]);
    }

    bool ok = vo.process(matches);
    auto t1 = chrono::steady_clock::now();
    total_s += chrono::duration<double>(t1 - t0).count();

    if (ok) {
      cv::Mat motion = vo.getMotion();
      pose = pose * motion.inv();
      ok_frames++;
    }
    traj.push_back(pose.clone());
    prev_l = cur_l; prev_r = cur_r;
  }

  // stdout: one pose per line (flattened 3x4), then a JSON summary line
  for (auto& T : traj) {
    for (int r = 0; r < 3; r++)
      for (int c = 0; c < 4; c++) printf("%.9g ", T.at<double>(r, c));
    printf("\n");
  }
  double fps = (n_frames - 1) / total_s;
  fprintf(stderr,
          "{\"frames\": %d, \"ok_frames\": %d, \"seconds\": %.4f, "
          "\"fps\": %.3f}\n",
          n_frames - 1, ok_frames, total_s, fps);
  return 0;
}
