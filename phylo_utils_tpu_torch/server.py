"""HTTP serving for a likelihood engine (PyTorch port of
``phylo_utils_tpu.server``).

Load the engine once (topology compiled, alignment resident on its device),
then serve logL / sitewise / gradient / fit / bootstrap requests over JSON. Stdlib-only
(ThreadingHTTPServer); engine calls are serialized by a lock, which is the
right behavior for a single-GPU replica — scale-out is one server per card
behind any standard load balancer.

Endpoints
---------
GET  /health            -> engine + device info
POST /loglik            {"params": {...}?}         -> {"loglik": x}
POST /sitewise          {"params": {...}?}         -> {"sitewise": [...]}
POST /gradient          {"params": {...}?}         -> {"gradient": {...}}
POST /fit               {"params": ..., "max_steps": n, "free": [...]}
                        -> {"loglik", "n_steps", "converged", "params"}
POST /bootstrap         {"n": 100, "seed": 0}      -> {"logliks": [...]}
POST /ancestral, /site_rates, /partitions
                        -> 501 until the port has them (ROADMAP A16, A18)
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from phylo_utils_tpu_torch.convert import params_to_numpy

__all__ = ["EngineServer", "serve"]

_NOT_PORTED = {
    "/ancestral": "ancestral reconstruction is not ported yet (ROADMAP A18)",
    "/site_rates": "site rates are not ported yet (ROADMAP A18)",
    "/partitions": "per-partition logL requires a PartitionedEngine "
                   "(ROADMAP A16)",
}


def _tree_to_json(tree) -> dict:
    """Nested dict of tensors -> the same nesting of (nested) lists."""
    return {k: (_tree_to_json(v) if isinstance(v, dict) else v.tolist())
            for k, v in params_to_numpy(tree).items()}


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class EngineServer:
    """Wraps a LikelihoodEngine behind HTTP."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8080):
        self.engine = engine
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- request handlers ----------------------------------------------------

    def _handle(self, route: str, body: dict) -> dict:
        engine = self.engine
        params = body.get("params")
        with self._lock:  # one engine call at a time
            if route == "/health":
                return {
                    "status": "ok",
                    "device": str(engine.device),
                    "device_name": _device_name(engine.device),
                    "pruner": engine.pruner,
                    "model": engine.model.name,
                    "n_patterns": int(engine._weights.shape[0]),
                }
            if route == "/loglik":
                return {"loglik": engine.loglikelihood(params)}
            if route == "/sitewise":
                return {
                    "sitewise": engine.sitewise_loglikelihoods(params).tolist()
                }
            if route == "/bootstrap":
                boots = engine.bootstrap_loglikelihoods(
                    int(body.get("n", 100)), params,
                    seed=int(body.get("seed", 0)),
                )
                return {"logliks": boots.tolist()}
            if route == "/gradient":
                return {"gradient": _tree_to_json(engine.gradient(params))}
            if route == "/fit":
                from phylo_utils_tpu_torch.optimize import fit

                res = fit(
                    engine,
                    params,
                    free=tuple(body["free"]) if body.get("free") else None,
                    max_steps=int(body.get("max_steps", 200)),
                    steps_per_call=int(body.get("steps_per_call", 1)),
                )
                return {
                    "loglik": res.loglik,
                    "n_steps": res.n_steps,
                    "converged": res.converged,
                    "params": _tree_to_json(res.params),
                }
            if route in _NOT_PORTED:
                raise NotImplementedError(_NOT_PORTED[route])
        raise KeyError(route)

    # -- server lifecycle ----------------------------------------------------

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _dispatch(self, route: str, body: dict):
                try:
                    self._reply(200, outer._handle(route, body))
                except KeyError:
                    self._reply(404, {"error": f"unknown route {route}"})
                except NotImplementedError as exc:
                    self._reply(501, {"error": str(exc)})
                except Exception as exc:  # surface as a clean 400
                    self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})

            def do_GET(self):
                if self.path == "/health":
                    self._dispatch("/health", {})
                else:
                    self._reply(404, {"error": f"unknown route {self.path}"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except Exception as exc:
                    self._reply(400, {"error": f"bad JSON body: {exc}"})
                    return
                self._dispatch(self.path, body)

        return Handler

    def start(self) -> int:
        """Start serving in a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), self._make_handler()
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def serve_forever(self):
        """Serve until interrupted, printing the URL as one JSON line
        first."""
        port = self.start()
        print(json.dumps({"serving": f"http://{self.host}:{port}"}),
              flush=True)
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.stop()


def serve(engine, host: str = "127.0.0.1", port: int = 8080) -> None:
    """Blocking: serve ``engine`` on ``host:port`` until interrupted."""
    EngineServer(engine, host, port).serve_forever()
