// Reference CPU baseline harness — MONO path.
//
// Compiles the reference library's actual mono-VO hot path
// (MonoVisualOdometry::process -> cv::findEssentialMat + cv::recoverPose,
// /root/reference/src/vo/MonoVisualOdometry.cpp:7-73, built unmodified)
// together with the OpenCV consumer front-end the reference assumes
// (GFTT detection + temporal PyrLK). Times the full per-frame loop and
// dumps the pose chain for ATE evaluation.
//
// Scale: recoverPose returns a unit-norm translation; the library's
// findRelativeScale is PRIVATE and unused by process(), and m_pts is
// cleared but never filled (recoverPose's triangulation is discarded,
// MonoVisualOdometry.cpp:29-31), so a consumer of the published API cannot
// propagate relative scale from library outputs. The chain therefore uses
// a fixed known speed passed on the command line — the same initial-speed
// courtesy the JAX mono pipeline bench receives (which can then propagate
// relative scale from its own triangulated structure; the reference
// consumer cannot).
//
// Usage: ref_mono <frames_dir> <n_frames> <fu> <fv> <cu> <cv> <speed>
//   frames_dir must contain L_%06d.png.

#include <chrono>
#include <cstdio>
#include <iostream>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/video/tracking.hpp>

#include "vo/MonoVisualOdometry.h"

using namespace std;

// As shipped, MonoVisualOdometry is ABSTRACT: the base class declares the
// pure virtual `cv::Mat getMotion() = 0` (VisualOdometry.h:38, non-const)
// while MonoVisualOdometry only provides `getMotion() const`
// (MonoVisualOdometry.h:33) — a const-mismatch that does not override, so
// the published class cannot be instantiated. Every consumer must add this
// one-line shim (benchmark-only; the library source is untouched).
struct MonoVO : me::MonoVisualOdometry {
  using me::MonoVisualOdometry::MonoVisualOdometry;
  cv::Mat getMotion() override {
    return static_cast<const me::MonoVisualOdometry&>(*this).getMotion();
  }
};

static vector<cv::Point2f> detect(const cv::Mat& img, int max_feats) {
  vector<cv::Point2f> pts;
  cv::goodFeaturesToTrack(img, pts, max_feats, 0.01, 10);
  return pts;
}

static void track(const cv::Mat& a, const cv::Mat& b,
                  const vector<cv::Point2f>& pa, vector<cv::Point2f>& pb,
                  vector<uchar>& status) {
  vector<float> err;
  if (pa.empty()) return;
  cv::calcOpticalFlowPyrLK(a, b, pa, pb, status, err, cv::Size(21, 21), 3);
}

int main(int argc, char** argv) {
  if (argc < 8) {
    fprintf(stderr, "usage: %s dir n fu fv cu cv speed\n", argv[0]);
    return 1;
  }
  string dir = argv[1];
  int n_frames = atoi(argv[2]);
  me::MonoVisualOdometry::parameters p;
  p.fu = atof(argv[3]);
  p.fv = atof(argv[4]);
  p.cu = atof(argv[5]);
  p.cv = atof(argv[6]);
  double speed = atof(argv[7]);
  // base defaults: ransac=true, inlier_threshold=2.0 (VisualOdometry.h:32)
  MonoVO vo(p);

  char buf[512];
  auto load = [&](int i) {
    snprintf(buf, sizeof(buf), "%s/L_%06d.png", dir.c_str(), i);
    cv::Mat m = cv::imread(buf, cv::IMREAD_GRAYSCALE);
    if (m.empty()) { fprintf(stderr, "missing %s\n", buf); exit(2); }
    return m;
  };

  cv::Mat prev = load(0);
  cv::Mat pose = cv::Mat::eye(4, 4, CV_64F);
  vector<cv::Mat> traj{pose.clone()};

  double total_s = 0.0;
  int ok_frames = 0;
  for (int i = 1; i < n_frames; i++) {
    cv::Mat cur = load(i);
    auto t0 = chrono::steady_clock::now();

    vector<cv::Point2f> f1 = detect(prev, 500);
    vector<cv::Point2f> f2;
    vector<uchar> s12;
    track(prev, cur, f1, f2, s12);

    vector<me::StereoMatchf> matches;
    for (size_t k = 0; k < f1.size(); k++) {
      if (!s12[k]) continue;
      matches.emplace_back(f1[k], f2[k]);
    }

    bool ok = vo.process(matches);
    auto t1 = chrono::steady_clock::now();
    total_s += chrono::duration<double>(t1 - t0).count();

    if (ok) {
      cv::Mat motion = vo.getMotion();  // unit-norm translation
      motion.col(3).rowRange(0, 3) *= speed;
      pose = pose * motion.inv();
      ok_frames++;
    }
    traj.push_back(pose.clone());
    prev = cur;
  }

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
