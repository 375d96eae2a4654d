// Framed-TCP graph optimization server.
//
// Native equivalent of the reference's boost::asio stack (reference
// remote/conn/ConnectionManagerServer.h:10-68, ConnectionHandlerBase.h:15-128,
// ConnectionHandlerGraph.h:5-52, session orchestration
// remote/app/ConnectionHandler.h:7-52) built on plain POSIX sockets: an
// accept loop hands each connection to the thread pool; a session loops
// reading one length-prefixed graph frame, dispatching it to the optimize
// callback (the embedded JAX engine via the C ABI, or the built-in native
// CPU optimizer), and writing the optimized graph back as one frame.
// Like the reference, the server is stateless between requests
// (ConnectionHandler.h:14-37) and a dead session never takes down the
// accept loop (ConnectionManagerServer.h:58).
#pragma once

#include <atomic>
#include <cstdint>
#include <memory>
#include <string>

#include "toyslam/graph.h"
#include "toyslam/thread_pool.h"

extern "C" {
// Optimize `g` in place; return 0 on success. A nonzero return closes the
// session with no reply (the client treats it as a failed request).
typedef int (*ts_optimize_cb)(TsGraph* g, void* user);
}

namespace toyslam {

class Server {
 public:
  Server(std::string host, uint16_t port, ts_optimize_cb cb, void* user,
         size_t num_threads = 4);
  ~Server();

  // Bind + listen. Returns false on socket errors.
  bool initialize();
  // Actual bound port (useful with port 0).
  uint16_t port() const { return port_; }
  // Blocking accept loop; returns after stop().
  void run();
  void stop();

 private:
  void handle_session(int fd);

  std::string host_;
  uint16_t port_;
  ts_optimize_cb cb_;
  void* user_;
  int listen_fd_ = -1;
  std::atomic<bool> stopping_{false};
  ThreadPool pool_;
};

}  // namespace toyslam
