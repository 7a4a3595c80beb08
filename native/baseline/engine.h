// Native host engine for shermbot_navigation.
//
// This is the C++ runtime component of the framework: a faithful
// reimplementation of the reference SLAM math (sziselman/Shermbot-Navigation,
// slam_library.cpp / tube_world.cpp / circle_fit_library.cpp semantics) with
// dense O(D^3) covariance algebra, used as
//   (a) the measured performance/trajectory baseline (BASELINE.md: "the C++
//       baseline must be measured, not quoted"),
//   (b) an in-process host serving engine (capi.cpp + ctypes bindings in
//       shermbot_navigation/native) for latency-critical single-robot
//       deployment where a device round-trip is not available, and
//   (c) the oracle the JAX engine is diffed against in tests.
//
// Independent reimplementation — NOT a copy of the reference sources, and NOT
// the JAX engine (which replaces the dense products with rank-2 updates).

#ifndef SHERMBOT_NATIVE_ENGINE_H_
#define SHERMBOT_NATIVE_ENGINE_H_

#include <cstdint>
#include <random>
#include <string>
#include <vector>

namespace shermbot {

constexpr double kPi = 3.14159265358979323846;

double wrap_angle(double a);

// ----------------------------------------------------------------------
// Minimal dense matrix helpers (row-major)
// ----------------------------------------------------------------------
struct Mat {
  int r = 0, c = 0;
  std::vector<double> v;
  Mat() = default;
  Mat(int r_, int c_) : r(r_), c(c_), v((size_t)r_ * c_, 0.0) {}
  double& operator()(int i, int j) { return v[(size_t)i * c + j]; }
  double operator()(int i, int j) const { return v[(size_t)i * c + j]; }
  static Mat eye(int n) {
    Mat m(n, n);
    for (int i = 0; i < n; ++i) m(i, i) = 1.0;
    return m;
  }
};

Mat mul(const Mat& a, const Mat& b);
Mat tr(const Mat& a);
Mat inv(Mat a);  // Gauss-Jordan with partial pivoting (small matrices only)

// ----------------------------------------------------------------------
// SE(2) + diff drive (same math as rigid2d; closed-form screw integration)
// ----------------------------------------------------------------------
struct Drive {
  double th = 0, x = 0, y = 0, wl = 0, wr = 0;  // pose + wheel angles
};

struct Geom {
  double wheel_base = 0.16, wheel_rad = 0.033;
};

void wheels_to_twist(const Geom& g, double dl, double dr, double* dth,
                     double* dx);
void drive_step(const Geom& g, Drive* d, double wl_new, double wr_new);

// ----------------------------------------------------------------------
// EKF-SLAM, dense (the reference's algorithm: slam_library.cpp)
// ----------------------------------------------------------------------
struct EKF {
  int n = 0;            // landmark capacity
  int dim = 0;          // 3 + 2n
  int seen = 0;
  std::vector<char> slot_seen;
  std::vector<double> mean;  // [th, x, y, m...]
  Mat cov;
  Mat Q;  // 3x3
  Mat R;  // 2x2
  double match_gate = 0.01, new_gate = 60.0;

  void init(int n_, const Mat& Q_, const Mat& R_, double init_cov);
  void predict(double dth, double dx);
  void zhat_H(int j, double* zr, double* zb, Mat* H) const;
  void init_landmark(int j, double zr, double zb);
  void update(int j, double zr, double zb);
  // first-hit association (SURVEY 2.4): >=0 slot, -1 gray-area skip,
  // -2 capacity overflow
  int associate(double zr, double zb);
};

// ----------------------------------------------------------------------
// World sim (tube_world semantics incl. the slip quirk)
// ----------------------------------------------------------------------
struct World {
  std::vector<double> tx, ty;  // tube centers
  double tube_rad = 0.0381, robot_rad = 0.08;
  double max_range = 1.0, tube_var = 0.001;
  double twist_noise = 0.0, slip_min = 0.9, slip_max = 1.0;
  bool lidar_quirks = false;  // reproduce the reference lidar's bugs
  Geom geom;

  Drive truth;              // true robot (slip-perturbed wheels)
  double cwl = 0, cwr = 0;  // commanded wheel angles (published joints)

  std::mt19937_64 rng{12345};
  bool deterministic = true;

  double gauss(double mean, double std);
  void substep(double cmd_w, double cmd_v, double dt);
  void lidar(std::vector<double>* ranges) const;
  void lidar_quirks_scan(std::vector<double>* ranges) const;
  void fake_sensor(std::vector<double>* mx, std::vector<double>* my,
                   std::vector<char>* valid) const;
};

// ----------------------------------------------------------------------
// Perception: clustering + inscribed-angle classify + Hyperaccurate fit
// (reference circle_fit_library semantics; 4x4 eigen via cyclic Jacobi)
// ----------------------------------------------------------------------
struct Pt { double x, y; };

std::vector<std::vector<Pt>> cluster_scan(const std::vector<double>& r,
                                          double minR, double maxR);
bool classify_circle(const std::vector<Pt>& c);
void eigh4(double A[4][4], double lam[4], double V[4][4]);
bool fit_circle(const std::vector<Pt>& c, double* ox, double* oy,
                double* orad);
void detect_landmarks(const std::vector<double>& scan,
                      std::vector<double>* mx, std::vector<double>* my);

// ----------------------------------------------------------------------
// Scenarios (kept in sync with pipeline/config.py by hand)
// ----------------------------------------------------------------------
struct Scenario {
  std::string name;
  std::vector<double> tx, ty;
  int num_landmarks = 0;
  bool known_assoc = false;
  bool use_lidar = false;
  bool lidar_quirks = false;
  int steps = 0;
  double cmd_w = 0, cmd_v = 0;
  double max_range = 1, tube_var = 0, twist_noise = 0, slip_min = 1,
         slip_max = 1;
};

Scenario get_scenario(const std::string& name);

// ----------------------------------------------------------------------
// Engine: one full SLAM pipeline instance (sim + odometry + EKF), the
// in-process equivalent of the reference's roslaunch graph.
// ----------------------------------------------------------------------
struct Engine {
  Scenario sc;
  World world;
  Drive odom;
  EKF ekf;
  int ticks = 0;
  double sum_sq = 0, sum_sq_od = 0;  // running squared position errors

  static constexpr int kSubsteps = 5;      // 50 Hz sim / 10 Hz filter
  static constexpr double kDt = 1.0 / 50;

  void init(const Scenario& s, bool deterministic, uint64_t seed);
  // One 10 Hz SLAM tick: 5 sim substeps -> odometry -> perceive -> EKF
  // predict + sequential per-measurement updates. Returns landmarks seen.
  int tick(double cmd_w, double cmd_v);
  double ate() const;       // RMS slam position error vs truth so far
  double ate_odom() const;  // RMS odometry position error vs truth so far
};

int run_bigmap(int N, int ticks, int M);  // config-4 dense baseline timing

}  // namespace shermbot

#endif  // SHERMBOT_NATIVE_ENGINE_H_
