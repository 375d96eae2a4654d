#include "toyslam/optimizer.h"

#include <cmath>
#include <cstring>
#include <memory>
#include <unordered_map>
#include <vector>

#include "toyslam/thread_pool.h"
#include "toyslam/timer.h"

namespace {

inline double wrap_angle(double t) { return std::atan2(std::sin(t), std::cos(t)); }

struct Accum {
  std::vector<double> H;  // D x D row-major
  std::vector<double> b;  // D
  double err = 0.0;
  void init(size_t d) {
    H.assign(d * d, 0.0);
    b.assign(d, 0.0);
    err = 0.0;
  }
};

// Huber on chi^2 (reference graph_optimizer.py:106-115): returns the
// robustified error contribution and the information scale w.
inline void huber(double chi2, double delta, double* robust_err, double* w) {
  const double d2 = delta * delta;
  if (chi2 <= d2) {
    *robust_err = chi2;
    *w = 1.0;
  } else {
    const double s = std::sqrt(chi2 < 1e-30 ? 1e-30 : chi2);
    *robust_err = 2.0 * s * delta - d2;
    *w = delta / s;
  }
}

// rank-update H[off_a..][off_b..] += JA^T * (w*Winfo) * JB for diagonal Winfo
// with JA [r x da], JB [r x db] given densely.
inline void add_block(std::vector<double>& H, size_t D, size_t off_a,
                      size_t off_b, const double* JA, const double* JB,
                      const double* w_info, int r, int da, int db) {
  for (int a = 0; a < da; ++a) {
    for (int b = 0; b < db; ++b) {
      double acc = 0.0;
      for (int k = 0; k < r; ++k) {
        acc += JA[k * da + a] * w_info[k] * JB[k * db + b];
      }
      H[(off_a + a) * D + off_b + b] += acc;
    }
  }
}

inline void add_grad(std::vector<double>& b, size_t off, const double* J,
                     const double* w_info, const double* res, int r, int d) {
  for (int a = 0; a < d; ++a) {
    double acc = 0.0;
    for (int k = 0; k < r; ++k) acc += J[k * d + a] * w_info[k] * res[k];
    b[off + a] += acc;
  }
}

// Edge-range assembly: [e0, e1) odometry edges then [l0, l1) landmark edges.
void assemble_range(const TsGraph& g, const TsOptimizeOptions& o,
                    uint32_t e0, uint32_t e1, uint32_t l0, uint32_t l1,
                    Accum* acc) {
  const size_t D = 3ull * g.n_poses + 2ull * g.n_landmarks;
  auto pose_off = [](uint32_t p) { return 3ull * p; };
  auto lm_off = [&](uint32_t l) { return 3ull * g.n_poses + 2ull * l; };

  for (uint32_t e = e0; e < e1; ++e) {
    const uint32_t i = g.odom_i[e], j = g.odom_j[e];
    const float* pi = g.poses + 3ull * i;
    const float* pj = g.poses + 3ull * j;
    const float* m = g.odom_meas + 3ull * e;
    // rel = pi^-1 * pj; delta = meas^-1 * rel  (reference edges2d.py:65-73)
    const double ci = std::cos(pi[2]), si = std::sin(pi[2]);
    const double rx = ci * (pj[0] - pi[0]) + si * (pj[1] - pi[1]);
    const double ry = -si * (pj[0] - pi[0]) + ci * (pj[1] - pi[1]);
    const double rt = wrap_angle(static_cast<double>(pj[2]) - pi[2]);
    const double cm = std::cos(m[2]), sm = std::sin(m[2]);
    double res[3] = {cm * (rx - m[0]) + sm * (ry - m[1]),
                     -sm * (rx - m[0]) + cm * (ry - m[1]),
                     wrap_angle(rt - m[2])};
    const double info[3] = {g.odom_info[3 * e + 0], g.odom_info[3 * e + 1],
                            g.odom_info[3 * e + 2]};
    const double chi2 =
        res[0] * res[0] * info[0] + res[1] * res[1] * info[1] +
        res[2] * res[2] * info[2];
    double robust_err, w;
    huber(chi2, o.huber_delta, &robust_err, &w);
    acc->err += robust_err;
    const double wi[3] = {w * info[0], w * info[1], w * info[2]};
    // A = -I, B = I (the reference's approximation, edges2d.py:75-77)
    static const double A[9] = {-1, 0, 0, 0, -1, 0, 0, 0, -1};
    static const double B[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    const size_t oi = pose_off(i), oj = pose_off(j);
    add_block(acc->H, D, oi, oi, A, A, wi, 3, 3, 3);
    add_block(acc->H, D, oi, oj, A, B, wi, 3, 3, 3);
    add_block(acc->H, D, oj, oi, B, A, wi, 3, 3, 3);
    add_block(acc->H, D, oj, oj, B, B, wi, 3, 3, 3);
    add_grad(acc->b, oi, A, wi, res, 3, 3);
    add_grad(acc->b, oj, B, wi, res, 3, 3);
  }

  for (uint32_t e = l0; e < l1; ++e) {
    const uint32_t p = g.lme_pose[e], l = g.lme_lm[e];
    const float* ps = g.poses + 3ull * p;
    const float* lm = g.landmarks + 2ull * l;
    const float* m = g.lme_meas + 2ull * e;
    const double c = std::cos(ps[2]), s = std::sin(ps[2]);
    const double dx = lm[0] - ps[0], dy = lm[1] - ps[1];
    // residual and analytic Jacobians (reference edges2d.py:21-53)
    double res[2] = {c * dx + s * dy - m[0] * std::cos(m[1]),
                     -s * dx + c * dy - m[0] * std::sin(m[1])};
    const double A[6] = {-c, -s, c * lm[1] - s * lm[0] - c * ps[1] + s * ps[0],
                         s,  -c, -s * lm[1] - c * lm[0] + s * ps[1] + c * ps[0]};
    const double B[4] = {c, s, -s, c};
    const double info[2] = {g.lme_info[2 * e + 0], g.lme_info[2 * e + 1]};
    const double chi2 =
        res[0] * res[0] * info[0] + res[1] * res[1] * info[1];
    double robust_err, w;
    huber(chi2, o.huber_delta, &robust_err, &w);
    acc->err += robust_err;
    const double wi[2] = {w * info[0], w * info[1]};
    const size_t op = pose_off(p), ol = lm_off(l);
    add_block(acc->H, D, op, op, A, A, wi, 2, 3, 3);
    add_block(acc->H, D, op, ol, A, B, wi, 2, 3, 2);
    add_block(acc->H, D, ol, op, B, A, wi, 2, 2, 3);
    add_block(acc->H, D, ol, ol, B, B, wi, 2, 2, 2);
    add_grad(acc->b, op, A, wi, res, 2, 3);
    add_grad(acc->b, ol, B, wi, res, 2, 2);
  }
}

// In-place lower Cholesky; returns false if a pivot collapses.
bool cholesky(std::vector<double>& H, size_t D) {
  for (size_t k = 0; k < D; ++k) {
    double d = H[k * D + k];
    for (size_t m = 0; m < k; ++m) d -= H[k * D + m] * H[k * D + m];
    if (d <= 0.0 || !std::isfinite(d)) return false;
    const double lkk = std::sqrt(d);
    H[k * D + k] = lkk;
    const double inv = 1.0 / lkk;
    for (size_t r = k + 1; r < D; ++r) {
      double v = H[r * D + k];
      for (size_t m = 0; m < k; ++m) v -= H[r * D + m] * H[k * D + m];
      H[r * D + k] = v * inv;
    }
  }
  return true;
}

void cholesky_solve(const std::vector<double>& L, size_t D,
                    std::vector<double>& x) {
  for (size_t r = 0; r < D; ++r) {
    double v = x[r];
    for (size_t m = 0; m < r; ++m) v -= L[r * D + m] * x[m];
    x[r] = v / L[r * D + r];
  }
  for (size_t r = D; r-- > 0;) {
    double v = x[r];
    for (size_t m = r + 1; m < D; ++m) v -= L[m * D + r] * x[m];
    x[r] = v / L[r * D + r];
  }
}

}  // namespace

extern "C" {

void ts_optimize_options_default(TsOptimizeOptions* o) {
  o->iterations = 10;
  o->lr = 0.2f;
  o->huber_delta = 1.5f;
  o->lambda_init = 1e-3f;
  o->lambda_min = 1e-6f;
  o->lambda_max = 1e1f;
  o->lambda_factor = 1.1f;
  o->fixed_prior = 1e6f;
  o->convergence_eps = 1e-3f;
  o->penalty_limit = 2;
  o->num_threads = 0;
}

int ts_optimize(TsGraph* g, const TsOptimizeOptions* opts,
                TsOptimizeStats* stats) {
  toyslam::ScopedTimer timer("Optimize");
  TsOptimizeOptions o;
  if (opts) {
    o = *opts;
  } else {
    ts_optimize_options_default(&o);
  }
  const size_t D = 3ull * g->n_poses + 2ull * g->n_landmarks;
  if (stats) {
    stats->iterations_run = 0;
    stats->final_chi2 = 0.0f;
    stats->converged = 0;
    stats->diverged = 0;
  }
  if (D == 0) return 0;

  // fixed wire ids -> state offsets
  std::unordered_map<uint32_t, size_t> pose_by_id, lm_by_id;
  for (uint32_t p = 0; p < g->n_poses; ++p) pose_by_id[g->pose_ids[p]] = p;
  for (uint32_t l = 0; l < g->n_landmarks; ++l) lm_by_id[g->lm_ids[l]] = l;
  std::vector<std::pair<size_t, int>> fixed;  // (offset, dim)
  for (uint32_t k = 0; k < g->n_fixed; ++k) {
    auto it = pose_by_id.find(g->fixed_ids[k]);
    if (it != pose_by_id.end()) {
      fixed.emplace_back(3ull * it->second, 3);
      continue;
    }
    auto it2 = lm_by_id.find(g->fixed_ids[k]);
    if (it2 != lm_by_id.end())
      fixed.emplace_back(3ull * g->n_poses + 2ull * it2->second, 2);
  }

  // Per-thread chunked accumulators: k extra D^2 buffers. Worth it only
  // while the buffers stay cache/memory friendly; large graphs go serial
  // (the JAX engine is the scaling path, this backend is the oracle).
  size_t n_threads =
      o.num_threads > 0
          ? static_cast<size_t>(o.num_threads)
          : static_cast<size_t>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (D > 2048 || (g->n_odom + g->n_lm_edges) < 256) n_threads = 1;
  std::unique_ptr<toyslam::ThreadPool> pool;
  if (n_threads > 1) pool.reset(new toyslam::ThreadPool(n_threads));
  std::vector<Accum> accs(n_threads);

  std::vector<double> H, b, dx;
  double lambda = o.lambda_init;
  double prev_err = -1.0;
  int penalty = 0;

  for (int iter = 0; iter < o.iterations; ++iter) {
    {
      toyslam::ScopedTimer t_assemble("CalculateHb");
      if (n_threads == 1) {
        accs[0].init(D);
        assemble_range(*g, o, 0, g->n_odom, 0, g->n_lm_edges, &accs[0]);
      } else {
        for (size_t t = 0; t < n_threads; ++t) {
          pool->submit([&, t] {
            accs[t].init(D);
            const uint32_t e0 =
                static_cast<uint32_t>(g->n_odom * t / n_threads);
            const uint32_t e1 =
                static_cast<uint32_t>(g->n_odom * (t + 1) / n_threads);
            const uint32_t l0 =
                static_cast<uint32_t>(g->n_lm_edges * t / n_threads);
            const uint32_t l1 =
                static_cast<uint32_t>(g->n_lm_edges * (t + 1) / n_threads);
            assemble_range(*g, o, e0, e1, l0, l1, &accs[t]);
          });
        }
        pool->wait_idle();
        for (size_t t = 1; t < n_threads; ++t) {
          for (size_t k = 0; k < D * D; ++k) accs[0].H[k] += accs[t].H[k];
          for (size_t k = 0; k < D; ++k) accs[0].b[k] += accs[t].b[k];
          accs[0].err += accs[t].err;
        }
      }
    }
    H = accs[0].H;
    b = accs[0].b;
    const double err = accs[0].err;
    if (stats) {
      stats->final_chi2 = static_cast<float>(err);
      stats->iterations_run = iter + 1;
    }

    // adaptive damping + divergence penalty (graph_optimizer.py:24-54)
    if (prev_err >= 0.0 && err > prev_err) {
      lambda = std::min<double>(lambda * o.lambda_factor, o.lambda_max);
      if (++penalty > o.penalty_limit) {
        if (stats) stats->diverged = 1;
        break;
      }
    } else {
      lambda = std::max<double>(lambda / o.lambda_factor, o.lambda_min);
      penalty = 0;
    }
    prev_err = err;

    // gauge priors (graph_optimizer.py:146-150) + damping
    for (const auto& f : fixed) {
      for (int a = 0; a < f.second; ++a) {
        H[(f.first + a) * D + f.first + a] += o.fixed_prior;
        b[f.first + a] = 0.0;
      }
    }
    for (size_t k = 0; k < D; ++k) H[k * D + k] += lambda;

    {
      toyslam::ScopedTimer t_solve("Solve");
      if (!cholesky(H, D)) return 1;
      dx = b;
      for (auto& v : dx) v = -v;
      cholesky_solve(H, D, dx);
    }

    // scaled update + retraction (vertices.py:28-46)
    double dx_norm2 = 0.0;
    for (auto& v : dx) {
      v *= o.lr;
      dx_norm2 += v * v;
    }
    for (uint32_t p = 0; p < g->n_poses; ++p) {
      g->poses[3 * p + 0] += static_cast<float>(dx[3ull * p + 0]);
      g->poses[3 * p + 1] += static_cast<float>(dx[3ull * p + 1]);
      g->poses[3 * p + 2] = static_cast<float>(
          wrap_angle(g->poses[3 * p + 2] + dx[3ull * p + 2]));
    }
    const size_t lm0 = 3ull * g->n_poses;
    for (uint32_t l = 0; l < g->n_landmarks; ++l) {
      g->landmarks[2 * l + 0] += static_cast<float>(dx[lm0 + 2ull * l + 0]);
      g->landmarks[2 * l + 1] += static_cast<float>(dx[lm0 + 2ull * l + 1]);
    }

    if (std::sqrt(dx_norm2) < o.convergence_eps) {
      if (stats) stats->converged = 1;
      break;
    }
  }
  return 0;
}

}  // extern "C"
