"""Graph optimization servers.

Two interchangeable servers speak the framed graph protocol (io/codec.py):

* :func:`native_server` — the C++ runtime (native/src/server.cpp: POSIX
  sockets, thread pool, native codec) with the optimizer pluggable per
  backend, the native analogue of the reference's boost::asio server
  (reference remote/app/main.cpp:5-48):

  - ``backend="jax"``: the JAX engine as the optimize callback — native
    transport/codec, XLA compute;
  - ``backend="native"``: zero-Python request path, the built-in C++ CPU
    Gauss-Newton (native/src/optimizer.cpp).

* :class:`PyGraphServer` — pure asyncio, for toolchain-less environments
  and as a protocol reference implementation.

Both are stateless per request, like the reference (ConnectionHandler.h:14-37).
"""

from __future__ import annotations

import asyncio
import struct
import threading
from typing import Callable, Optional

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.io import codec
from toyslam_tpu.models.graph import FactorGraph2D

OptimizeFn = Callable[[FactorGraph2D], FactorGraph2D]


def jax_optimize_fn(cfg: Optional[OptimizerConfig] = None) -> OptimizeFn:
    """The JAX engine as a server callback (GaussNewton.optimize)."""
    from toyslam_tpu.optimizer import GaussNewton

    gn = GaussNewton(cfg or OptimizerConfig(solver="schur"))

    def optimize(graph: FactorGraph2D) -> FactorGraph2D:
        import numpy as np

        result = gn.optimize(graph)
        import dataclasses

        return dataclasses.replace(
            graph,
            poses=np.asarray(result.graph.poses),
            landmarks=np.asarray(result.graph.landmarks),
        )

    return optimize


def native_server(
    backend: str = "jax",
    host: str = "127.0.0.1",
    port: int = 0,
    cfg: Optional[OptimizerConfig] = None,
    num_threads: int = 4,
):
    """Create (unstarted) a native TCP server for the given backend."""
    from toyslam_tpu.io.native import NativeServer

    fn = None if backend == "native" else jax_optimize_fn(cfg)
    return NativeServer(fn, host=host, port=port, num_threads=num_threads)


class PyGraphServer:
    """Pure-Python asyncio server (protocol reference / fallback)."""

    def __init__(
        self,
        optimize_fn: OptimizeFn,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.optimize_fn = optimize_fn
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()

    async def _handle(self, reader, writer):
        try:
            while True:
                head = await reader.readexactly(4)
                (size,) = struct.unpack("<I", head)
                body = await reader.readexactly(size)
                graph = codec.bytes_to_graph(head + body)
                result = await asyncio.get_event_loop().run_in_executor(
                    None, self.optimize_fn, graph
                )
                writer.write(codec.graph_to_bytes(result))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def _serve(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        async with self._server:
            await self._server.serve_forever()

    def start(self) -> "PyGraphServer":
        """Run the server on a background thread with its own loop."""

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._serve())
            except asyncio.CancelledError:
                pass
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("server failed to start")
        return self

    def stop(self) -> None:
        if self._loop is not None and self._server is not None:
            def _shutdown():
                self._server.close()
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()

            self._loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
