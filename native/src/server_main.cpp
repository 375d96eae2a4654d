// Standalone native optimization server.
//
// CLI-compatible role with the reference server entry (reference
// remote/app/main.cpp:5-48: HOST PORT ITERATIONS PIPELINE SOLVER). The
// native build has a single pipeline (the built-in CPU Gauss-Newton,
// toyslam/optimizer.h) — the JAX pipeline is served by the Python host
// (python -m toyslam_tpu.app serve), which embeds the same server via the
// C ABI and plugs the JAX engine in as the optimize callback.
#include <csignal>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "toyslam/optimizer.h"
#include "toyslam/server.h"
#include "toyslam/timer.h"

namespace {

TsOptimizeOptions g_options;

int optimize_cb(TsGraph* g, void*) {
  TsOptimizeStats stats;
  int rc = ts_optimize(g, &g_options, &stats);
  std::fprintf(stderr,
               "[server] optimized: %d iters, chi2 %.3f, converged=%d\n",
               stats.iterations_run, stats.final_chi2, stats.converged);
  return rc;
}

toyslam::Server* g_server = nullptr;

void on_signal(int) {
  if (g_server) g_server->stop();
}

}  // namespace

int main(int argc, char** argv) {
  const char* host = argc > 1 ? argv[1] : "127.0.0.1";
  const uint16_t port =
      argc > 2 ? static_cast<uint16_t>(std::atoi(argv[2])) : 8888;
  ts_optimize_options_default(&g_options);
  if (argc > 3) g_options.iterations = std::atoi(argv[3]);
  toyslam::set_verbose(true);

  toyslam::Server server(host, port, optimize_cb, nullptr);
  if (!server.initialize()) {
    std::fprintf(stderr, "failed to bind %s:%u\n", host, port);
    return 1;
  }
  g_server = &server;
  std::signal(SIGINT, on_signal);
  std::signal(SIGTERM, on_signal);
  std::fprintf(stderr, "toyslam native server on %s:%u (%d iterations)\n",
               host, server.port(), g_options.iterations);
  server.run();
  return 0;
}
