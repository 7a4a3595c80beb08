// C API over the native host engine (engine.h), consumed from Python via
// ctypes (shermbot_navigation/native). Exposes:
//   - full pipeline instances (create/tick/poses/state/destroy)
//   - the standalone perception stage (scan -> landmark detections)
// All arrays are caller-allocated doubles; all functions are thread-safe per
// engine instance (no globals).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "engine.h"

using shermbot::Engine;
using shermbot::Scenario;

extern "C" {

// Opaque engine handle --------------------------------------------------
void* sb_engine_create(const char* scenario, int deterministic,
                       uint64_t seed) {
  Scenario sc = shermbot::get_scenario(scenario ? scenario : "");
  if (sc.name.empty()) return nullptr;
  Engine* e = new Engine();
  e->init(sc, deterministic != 0, seed);
  return e;
}

// Custom world: tube centers + pipeline knobs (mirrors pipeline/config.py).
void* sb_engine_create_custom(const double* tx, const double* ty,
                              int n_tubes, int capacity, int known_assoc,
                              int use_lidar, int lidar_quirks,
                              double max_range,
                              double tube_var, double twist_noise,
                              double slip_min, double slip_max,
                              double cmd_w, double cmd_v, int steps,
                              int deterministic, uint64_t seed) {
  Scenario sc;
  sc.name = "custom";
  sc.tx.assign(tx, tx + n_tubes);
  sc.ty.assign(ty, ty + n_tubes);
  sc.num_landmarks = capacity;
  sc.known_assoc = known_assoc != 0;
  sc.use_lidar = use_lidar != 0;
  sc.lidar_quirks = lidar_quirks != 0;
  sc.steps = steps;
  sc.cmd_w = cmd_w;
  sc.cmd_v = cmd_v;
  sc.max_range = max_range;
  sc.tube_var = tube_var;
  sc.twist_noise = twist_noise;
  sc.slip_min = slip_min;
  sc.slip_max = slip_max;
  Engine* e = new Engine();
  e->init(sc, deterministic != 0, seed);
  return e;
}

void sb_engine_destroy(void* h) { delete static_cast<Engine*>(h); }

// One 10 Hz SLAM tick; returns the number of landmarks seen so far.
int sb_engine_tick(void* h, double cmd_w, double cmd_v) {
  return static_cast<Engine*>(h)->tick(cmd_w, cmd_v);
}

// out[9] = truth(th,x,y), odom(th,x,y), slam(th,x,y)
void sb_engine_poses(const void* h, double* out) {
  const Engine* e = static_cast<const Engine*>(h);
  out[0] = e->world.truth.th;
  out[1] = e->world.truth.x;
  out[2] = e->world.truth.y;
  out[3] = e->odom.th;
  out[4] = e->odom.x;
  out[5] = e->odom.y;
  out[6] = e->ekf.mean[0];
  out[7] = e->ekf.mean[1];
  out[8] = e->ekf.mean[2];
}

int sb_engine_state_dim(const void* h) {
  return static_cast<const Engine*>(h)->ekf.dim;
}

// mean_out: dim doubles
void sb_engine_state(const void* h, double* mean_out) {
  const Engine* e = static_cast<const Engine*>(h);
  std::memcpy(mean_out, e->ekf.mean.data(), e->ekf.dim * sizeof(double));
}

// cov_out: dim*dim doubles, row-major
void sb_engine_cov(const void* h, double* cov_out) {
  const Engine* e = static_cast<const Engine*>(h);
  std::memcpy(cov_out, e->ekf.cov.v.data(),
              (size_t)e->ekf.dim * e->ekf.dim * sizeof(double));
}

int sb_engine_seen(const void* h) {
  return static_cast<const Engine*>(h)->ekf.seen;
}

double sb_engine_ate(const void* h) {
  return static_cast<const Engine*>(h)->ate();
}

double sb_engine_ate_odom(const void* h) {
  return static_cast<const Engine*>(h)->ate_odom();
}

// Standalone perception stage: 360-ray scan -> detections (robot frame).
// Returns the number of detections written (<= max_out).
int sb_detect_landmarks(const double* scan, int n_rays, double* mx_out,
                        double* my_out, int max_out) {
  std::vector<double> s(scan, scan + n_rays);
  std::vector<double> mx, my;
  shermbot::detect_landmarks(s, &mx, &my);
  int n = (int)mx.size();
  if (n > max_out) n = max_out;
  for (int i = 0; i < n; ++i) {
    mx_out[i] = mx[i];
    my_out[i] = my[i];
  }
  return n;
}

// Standalone simulated lidar for an arbitrary pose/world (for tests).
// quirks != 0 selects the reference-faithful buggy scanner.
void sb_simulate_lidar(const double* tx, const double* ty, int n_tubes,
                       double tube_rad, double th, double x, double y,
                       int quirks, double* ranges_out /*360*/) {
  shermbot::World w;
  w.tx.assign(tx, tx + n_tubes);
  w.ty.assign(ty, ty + n_tubes);
  w.tube_rad = tube_rad;
  w.truth.th = th;
  w.truth.x = x;
  w.truth.y = y;
  w.lidar_quirks = quirks != 0;
  std::vector<double> r;
  w.lidar(&r);
  std::memcpy(ranges_out, r.data(), r.size() * sizeof(double));
}

// Standalone EKF handle ------------------------------------------------
// Exposes the filter primitives directly so hand-derived numeric fixtures
// (tests/test_reference_fixtures.py) can anchor this engine to the
// reference's published formulas (slam_library.cpp:71-186,263-282)
// independently of the JAX engine.
void* sb_ekf_create(int n, const double* q3 /*9, row-major*/,
                    const double* r2 /*4*/, double init_cov) {
  shermbot::EKF* e = new shermbot::EKF();
  shermbot::Mat Q(3, 3), R(2, 2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Q(i, j) = q3[i * 3 + j];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) R(i, j) = r2[i * 2 + j];
  e->init(n, Q, R, init_cov);
  return e;
}

void sb_ekf_destroy(void* h) { delete static_cast<shermbot::EKF*>(h); }

void sb_ekf_set_mean(void* h, const double* mean) {
  shermbot::EKF* e = static_cast<shermbot::EKF*>(h);
  std::memcpy(e->mean.data(), mean, e->dim * sizeof(double));
}

void sb_ekf_set_cov(void* h, const double* cov) {
  shermbot::EKF* e = static_cast<shermbot::EKF*>(h);
  std::memcpy(e->cov.v.data(), cov, (size_t)e->dim * e->dim * sizeof(double));
}

// marks slots 0..seen-1 as initialized (in-order fill, like the reference)
void sb_ekf_set_seen(void* h, int seen) {
  shermbot::EKF* e = static_cast<shermbot::EKF*>(h);
  e->seen = seen;
  for (int j = 0; j < e->n; ++j) e->slot_seen[j] = j < seen ? 1 : 0;
}

void sb_ekf_get_mean(const void* h, double* out) {
  const shermbot::EKF* e = static_cast<const shermbot::EKF*>(h);
  std::memcpy(out, e->mean.data(), e->dim * sizeof(double));
}

void sb_ekf_get_cov(const void* h, double* out) {
  const shermbot::EKF* e = static_cast<const shermbot::EKF*>(h);
  std::memcpy(out, e->cov.v.data(), (size_t)e->dim * e->dim * sizeof(double));
}

void sb_ekf_predict(void* h, double dth, double dx) {
  static_cast<shermbot::EKF*>(h)->predict(dth, dx);
}

void sb_ekf_update(void* h, int j, double zr, double zb) {
  static_cast<shermbot::EKF*>(h)->update(j, zr, zb);
}

void sb_ekf_init_landmark(void* h, int j, double zr, double zb) {
  static_cast<shermbot::EKF*>(h)->init_landmark(j, zr, zb);
}

int sb_ekf_associate(void* h, double zr, double zb) {
  return static_cast<shermbot::EKF*>(h)->associate(zr, zb);
}

// zhat2: [range, bearing]; h_out: 2 x dim row-major measurement Jacobian
void sb_ekf_zhat_h(const void* h, int j, double* zhat2, double* h_out) {
  const shermbot::EKF* e = static_cast<const shermbot::EKF*>(h);
  shermbot::Mat H;
  e->zhat_H(j, &zhat2[0], &zhat2[1], &H);
  std::memcpy(h_out, H.v.data(), (size_t)2 * e->dim * sizeof(double));
}

// SE(2) twist integration, general (w, vx, vy) closed form — the same map
// the reference builds via the center-of-rotation construction
// (rigid2d.cpp:294-328). out3 = [theta, x, y] of exp([w, vx, vy]).
void sb_integrate_twist(double w, double vx, double vy, double* out3) {
  double s1, s2;
  if (w == 0.0) {
    s1 = 1.0;
    s2 = 0.0;
  } else {
    s1 = std::sin(w) / w;
    s2 = (1.0 - std::cos(w)) / w;
  }
  out3[0] = w;
  out3[1] = s1 * vx - s2 * vy;
  out3[2] = s2 * vx + s1 * vy;
}

int sb_abi_version(void) { return 3; }

}  // extern "C"
