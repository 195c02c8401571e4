"""HTTP serving endpoint: a JSON prediction API around :class:`Predictor`.

The reference has no serving surface at all (SURVEY.md §1 L5); this is the
network-facing half of the serving layer — stdlib-only (no web framework
to pin), one compiled model per process, suitable behind any reverse proxy:

    python -m fall_multimodal_tpu_torch.serve serve \
        --config gstcan_urfall_3stream --checkpoint best_model.pt \
        --port 8000

    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/v1/predict -d \
        '{"skeleton": [[[...30x14x3...]]], "sensor": [[[...30x4...]]]}'

API:

* ``GET /healthz`` — liveness + model identity (config name, classes,
  compiled batch size).
* ``POST /v1/predict`` — body ``{"skeleton": nested list (N,T,V,C),
  "sensor": nested list (N,T,S) | absent}``; add ``"proba": true`` for
  per-class probabilities. Responds ``{"predictions": [int], "n": N
  [, "probabilities": [[float]]]}``.

Shape/validation errors return 400 with the reason. Request parsing runs
concurrently in the ThreadingHTTPServer's per-request threads; the device
forward runs on ONE dispatcher thread behind a coalescing queue
(:class:`RequestBatcher`): whenever the device is free the dispatcher
drains every waiting request into a single padded forward (capped at the
compiled batch) and fans the probability rows back out. A lone request is
picked up immediately — idle latency is unchanged — and batches form
exactly when the device is the bottleneck, so concurrent throughput
approaches the offline batch rate instead of one padded forward per
request. Eval-mode forwards are row-independent (BatchNorm uses running
stats), so coalesced results are identical to per-request calls.
``--checkpoint`` takes a reference checkpoint file (see
docs/migration.md).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

__all__ = ["PredictionServer", "RequestBatcher", "make_server"]

_MAX_BODY = 256 * 1024 * 1024  # refuse absurd request bodies outright


class _Pending:
    """One enqueued request: input windows, a done event, and a result slot."""

    __slots__ = ("skeleton", "sensor", "done", "proba", "error",
                 "t_enqueue", "queue_wait_ms", "service_ms")

    def __init__(self, skeleton: np.ndarray, sensor: Optional[np.ndarray]):
        self.skeleton = skeleton
        self.sensor = sensor
        self.done = threading.Event()
        self.proba: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        self.queue_wait_ms = 0.0   # enqueue -> dispatcher took the batch
        self.service_ms = 0.0      # batch taken -> forward done


class RequestBatcher:
    """Coalesce concurrent prediction requests into single device calls.

    ``submit`` blocks until the request's probability rows are ready. A
    single dispatcher thread owns the device: when it becomes free it takes
    every queued request (up to ``predictor.batch_size`` windows — the
    compiled shape — per device call; an oversized single request still
    goes through alone, the predictor chunks internally) and runs ONE
    padded forward for all of them.

    For models that do not consume the sensor stream the sensor is dropped
    before batching (the forward ignores it; keeping it would force every
    coalesced group to agree on a sensor shape for no effect).

    ``stats()`` reports device-call counts for observability and tests.
    """

    def __init__(self, predictor):
        self.predictor = predictor
        self._cond = threading.Condition()
        self._queue: List[_Pending] = []
        self._closed = False
        self._device_calls = 0
        self._requests = 0
        self._max_coalesced = 0
        # per-request (queue_wait_ms, service_ms) of the most recent
        # requests, for tail-latency attribution (experiments/
        # serve_concurrency.py splits client p99 into queue wait vs
        # device service vs HTTP/scheduling overhead)
        self._timings: deque = deque(maxlen=8192)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- client

    def submit(self, skeleton: np.ndarray,
               sensor: Optional[np.ndarray]) -> np.ndarray:
        """Enqueue (N, T, V, C) windows; block until their (N, K) rows are
        computed; raises whatever the forward raised for this group.

        Validates the cross-stream invariants BEFORE enqueueing: a request
        whose sensor row count disagrees with its skeleton row count must
        never enter a coalesced group (two such requests can make the
        concatenated totals match while misaligning every peer's sensor
        rows across request boundaries — silently wrong predictions with a
        200 status)."""
        if not self.predictor.requires_sensor:
            sensor = None
        elif sensor is None:
            raise ValueError(
                "model requires a sensor stream but sensor is None")
        if sensor is not None and len(sensor) != len(skeleton):
            raise ValueError(
                f"sensor has {len(sensor)} windows but skeleton has "
                f"{len(skeleton)}; counts must match")
        item = _Pending(skeleton, sensor)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(item)
            self._requests += 1
            self._cond.notify()
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.proba

    def stats(self) -> dict:
        with self._cond:
            return {
                "requests": self._requests,
                "device_calls": self._device_calls,
                "max_coalesced_requests": self._max_coalesced,
            }

    def drain_timings(self) -> List[tuple]:
        """Pop the recorded per-request (queue_wait_ms, service_ms) pairs
        (most recent 8192). In-process observability for load tests; not
        exposed over HTTP."""
        with self._cond:
            out = list(self._timings)
            self._timings.clear()
        return out

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            logging.getLogger(__name__).warning(
                "RequestBatcher dispatcher still running after close() "
                "(a device forward — likely a compile — is in flight; it "
                "will finish on the daemon thread)")

    # --------------------------------------------------------- dispatcher

    def _take_batch(self) -> List[_Pending]:
        """Pop queued requests whose windows fit one compiled forward.
        Call with the lock held and a non-empty queue."""
        cap = self.predictor.batch_size
        batch = [self._queue.pop(0)]
        total = len(batch[0].skeleton)
        while self._queue and total + len(self._queue[0].skeleton) <= cap:
            item = self._queue.pop(0)
            total += len(item.skeleton)
            batch.append(item)
        return batch

    def _loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:          # closed and drained
                    return
                batch = self._take_batch()
                self._device_calls += 1
                self._max_coalesced = max(self._max_coalesced, len(batch))
            t_dispatch = time.perf_counter()
            for item in batch:
                item.queue_wait_ms = (t_dispatch - item.t_enqueue) * 1e3
            try:
                skeleton = np.concatenate([b.skeleton for b in batch])
                sensor = (
                    np.concatenate([b.sensor for b in batch])
                    if batch[0].sensor is not None else None
                )
                proba = self.predictor.predict_proba(skeleton, sensor)
                start = 0
                for item in batch:
                    n = len(item.skeleton)
                    item.proba = proba[start : start + n]
                    start += n
            except BaseException as e:
                # Fan the failure out with a FRESH exception per request:
                # re-raising one shared instance concurrently in N handler
                # threads mutates a shared traceback and blames one
                # request's error text on its peers.
                for item in batch:
                    item.error = RuntimeError(
                        f"batched forward failed: {type(e).__name__}: {e}")
                if not isinstance(e, Exception):
                    raise  # KeyboardInterrupt/SystemExit: stop dispatching
            finally:
                service_ms = (time.perf_counter() - t_dispatch) * 1e3
                with self._cond:
                    for item in batch:
                        item.service_ms = service_ms
                        self._timings.append(
                            (item.queue_wait_ms, service_ms))
                for item in batch:
                    item.done.set()


class _Handler(BaseHTTPRequestHandler):
    # set on the class returned by make_server
    predictor = None
    batcher: RequestBatcher = None
    quiet = True

    def log_message(self, fmt, *args):  # route through logging, not stderr
        if not self.quiet:
            super().log_message(fmt, *args)

    # ------------------------------------------------------------ plumbing

    def _send_json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str):
        self._send_json(code, {"error": message})

    # ------------------------------------------------------------- routes

    def do_GET(self):
        if self.path != "/healthz":
            return self._error(404, f"no route {self.path!r}; GET /healthz")
        pred = self.predictor
        self._send_json(200, {
            "status": "ok",
            "model": pred.config.model.name,
            "num_classes": pred.config.data.num_classes,
            "batch_size": pred.batch_size,
            "requires_sensor": pred.requires_sensor,
            "batching": self.batcher.stats(),
        })

    def do_POST(self):
        if self.path != "/v1/predict":
            return self._error(404, f"no route {self.path!r}; POST /v1/predict")
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            return self._error(400, "bad Content-Length")
        if length <= 0:
            return self._error(400, "empty body; send a JSON object")
        if length > _MAX_BODY:
            return self._error(413, f"body over {_MAX_BODY} bytes")
        try:
            req = json.loads(self.rfile.read(length))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return self._error(400, f"invalid JSON: {e}")
        if not isinstance(req, dict) or "skeleton" not in req:
            return self._error(400, "body must be a JSON object with 'skeleton'")

        try:
            skeleton = np.asarray(req["skeleton"], np.float32)
            sensor = (
                np.asarray(req["sensor"], np.float32)
                if req.get("sensor") is not None else None
            )
        except (ValueError, TypeError) as e:
            return self._error(400, f"arrays are ragged or non-numeric: {e}")

        d = self.predictor.config.data
        if skeleton.ndim == 3:          # single window convenience
            skeleton = skeleton[None]
            if sensor is not None and sensor.ndim == 2:
                sensor = sensor[None]
        if skeleton.ndim != 4:
            return self._error(
                400, f"skeleton must be (N, T, V, C), got shape "
                     f"{tuple(skeleton.shape)}")
        if skeleton.shape[1:] != (d.seq_len, d.num_joints, d.in_channels):
            return self._error(
                400, f"skeleton windows must be "
                     f"({d.seq_len}, {d.num_joints}, {d.in_channels}), got "
                     f"{tuple(skeleton.shape[1:])}")
        if sensor is not None:
            # validate here: a wrong sensor shape reaching the jitted
            # forward raises TypeError/flax errors, not ValueError, which
            # would otherwise escape the handler as a connection reset
            if sensor.ndim != 3 or sensor.shape[1:] != (d.seq_len, d.sensor_dim):
                return self._error(
                    400, f"sensor windows must be "
                         f"({d.seq_len}, {d.sensor_dim}), got "
                         f"{tuple(sensor.shape[1:]) if sensor.ndim == 3 else tuple(sensor.shape)}")

        if self.predictor.requires_sensor and sensor is None:
            return self._error(
                400, f"model {self.predictor.config.model.name!r} "
                     f"requires a 'sensor' stream")
        if sensor is not None and sensor.shape[0] != skeleton.shape[0]:
            return self._error(
                400, f"sensor has {sensor.shape[0]} windows but skeleton "
                     f"has {skeleton.shape[0]}; counts must match")

        try:
            # enqueue on the coalescing dispatcher: concurrent requests
            # share one padded device forward instead of serializing.
            # Every per-request invariant was validated above, so anything
            # surfacing here is a server-side fault (possibly triggered by
            # a coalesced peer) — 500, never a 400 blaming this request.
            proba = self.batcher.submit(skeleton, sensor)
        except Exception as e:
            return self._error(500, f"{type(e).__name__}: {e}")
        out = {
            "predictions": [int(c) for c in proba.argmax(-1)],
            "n": int(len(proba)),
        }
        if req.get("proba"):
            out["probabilities"] = [[float(v) for v in row] for row in proba]
        self._send_json(200, out)


class _Server(ThreadingHTTPServer):
    # The stdlib default listen backlog is 5. Request coalescing releases
    # every waiting client in the same instant, and they all reconnect at
    # once (one connection per request); with backlog 5 the overflow SYNs
    # get RST — measured as ConnectionResetError at 32 concurrent clients
    # and ~1 s SYN-retransmit p99 inflation at 8 (experiments/
    # serve_concurrency.py). 128 covers any burst a single device can serve.
    request_queue_size = 128


class PredictionServer:
    """Owns a ``ThreadingHTTPServer`` bound to (host, port); ``port=0``
    picks an ephemeral port (``.port`` has the real one). Use ``serve()``
    to block, or ``start()``/``close()`` around a background thread."""

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 8000,
                 quiet: bool = True):
        self.batcher = RequestBatcher(predictor)
        handler = type("Handler", (_Handler,), {
            "predictor": predictor,
            "batcher": self.batcher,
            "quiet": quiet,
        })
        self._httpd = _Server((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    def serve(self):
        """Block serving requests until interrupted."""
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._httpd.server_close()
            self.batcher.close()

    def start(self):
        """Serve on a daemon thread (tests, embedding)."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.batcher.close()


def make_server(predictor, host: str = "127.0.0.1", port: int = 8000,
                quiet: bool = True) -> PredictionServer:
    return PredictionServer(predictor, host=host, port=port, quiet=quiet)
