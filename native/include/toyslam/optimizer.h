// Native CPU Gauss-Newton optimizer.
//
// The standalone fallback/oracle backend: same damped-GN semantics as the
// JAX engine (toyslam_tpu/optimizer/gauss_newton.py) and the reference
// Python optimizer (reference python/optimizer/graph_optimizer.py:20-155),
// so the three implementations cross-check each other — the
// "cross-implementation redundancy" oracle SURVEY.md §4 identifies.
// Differences from the reference C++ path (remote/optimizer/OptimizerCpu.h):
// lambda damping is actually applied (the reference declares lambdaVal and
// never uses it, OptimizerCpu.h:70), H/b accumulate in double (the reference
// accumulates in float), assembly fans out over a lock-free-chunked thread
// pool instead of a mutex (OptimizerCpu.h:101-118), and the solve is an
// in-place Cholesky instead of col-pivoted QR (H + lam I + gauge priors is
// SPD by construction).
#pragma once

#include <cstdint>

#include "toyslam/graph.h"

extern "C" {

typedef struct TsOptimizeOptions {
  int32_t iterations;     // default 10   (reference slam_main.py:30)
  float lr;               // default 0.2  (slam_main.py:31)
  float huber_delta;      // default 1.5  (graph_optimizer.py:108)
  float lambda_init;      // default 1e-3
  float lambda_min;       // default 1e-6 (graph_optimizer.py:24-43)
  float lambda_max;       // default 1e1
  float lambda_factor;    // default 1.1
  float fixed_prior;      // default 1e6  (graph_optimizer.py:149)
  float convergence_eps;  // default 1e-3 (graph_optimizer.py:90)
  int32_t penalty_limit;  // default 2    (graph_optimizer.py:47-54)
  int32_t num_threads;    // 0 = hardware_concurrency
} TsOptimizeOptions;

typedef struct TsOptimizeStats {
  int32_t iterations_run;
  float final_chi2;
  int32_t converged;  // stopped via ||lr*dx|| < eps
  int32_t diverged;   // stopped via the worsening-error penalty
} TsOptimizeStats;

void ts_optimize_options_default(TsOptimizeOptions* opts);

// Optimizes the graph in place. Returns 0 on success, nonzero on a
// numerically unsolvable system.
int ts_optimize(TsGraph* g, const TsOptimizeOptions* opts,
                TsOptimizeStats* stats);

}  // extern "C"
