"""Online serving: a micro-batching HTTP server over an exported artifact.

Port of ``endoscopy_tpu/serve/server.py``. ``BucketBatcher``, the handler
and ``ModelServer`` are stdlib plus numpy and are copied unchanged: a
dispatcher thread coalesces concurrent requests and pads each dispatch to
the smallest warmed bucket (1, 2, 4, ... max). ``make_server`` loads the
port's artifact (``serve/export.py``) on the card, warms every bucket there,
and reports the card's name as ``backend``.

Endpoints:

- ``POST /predict`` — one image per request. ``Content-Type:
  application/octet-stream`` sends a raw canonical uint8 ``(S, S, 3)``
  buffer; any other content type is decoded as an encoded image through
  the canonical cv2 pipeline (cv2 is imported only then). Response:
  ``{"pred": k, "max_prob": p, "probs": [...]}``.
- ``GET /healthz`` — artifact contract + backend.
- ``GET /stats`` — request/batch counts, per-bucket histogram, mean fill
  ratio, model-call latency percentiles.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np

_STOP = object()


class BucketBatcher:
    """Coalesce single-image requests into padded fixed-shape batches.

    ``submit`` enqueues an image and returns a Future resolving to that
    image's probability row. A daemon thread drains the queue: it waits for
    the first request, lingers up to ``max_wait_ms`` (or until the largest
    bucket fills), pads the group to the smallest bucket that holds it, and
    runs ``infer_fn`` once for the group.
    """

    def __init__(self, infer_fn, input_size: int,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 max_wait_ms: float = 5.0):
        if not buckets:
            raise ValueError("need at least one bucket size")
        self._infer = infer_fn
        self._size = int(input_size)
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0, "batches": 0, "errors": 0,
            "bucket_hist": collections.Counter(),
            "occupancy_sum": 0, "capacity_sum": 0,
        }
        self._latencies = collections.deque(maxlen=2048)  # model-call ms
        self._thread = threading.Thread(
            target=self._run, name="bucket-batcher", daemon=True)
        self._thread.start()

    # -- public API ---------------------------------------------------------

    def submit(self, image_u8: np.ndarray) -> Future:
        if image_u8.shape != (self._size, self._size, 3):
            raise ValueError(
                f"image shape {image_u8.shape} != canonical "
                f"({self._size}, {self._size}, 3)")
        fut: Future = Future()
        if self._closed:
            fut.set_exception(RuntimeError("server shutting down"))
            return fut
        self._q.put((np.asarray(image_u8, np.uint8), fut))
        # narrow race: the dispatcher drained and exited between the flag
        # check and the put — nobody will service the queue, so fail any
        # stranded items ourselves (idempotent)
        if self._closed and not self._thread.is_alive():
            self._drain_on_stop()
        return fut

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            occ, cap = self._stats["occupancy_sum"], self._stats["capacity_sum"]
            return {
                "requests": self._stats["requests"],
                "batches": self._stats["batches"],
                "errors": self._stats["errors"],
                "bucket_hist": dict(self._stats["bucket_hist"]),
                "mean_fill": (occ / cap) if cap else None,
                "model_ms_p50": lat[len(lat) // 2] if lat else None,
                "model_ms_p99": lat[int(len(lat) * 0.99)] if lat else None,
            }

    def close(self, join_timeout_s: float = 30.0) -> None:
        self._closed = True
        self._q.put(_STOP)
        self._thread.join(timeout=join_timeout_s)
        # This drain can consume the _STOP sentinel if the dispatcher is
        # still inside a long infer_fn call when the join expires; that is
        # safe because _collect polls _closed and exits without it.
        self._drain_on_stop()  # submits that raced past the dispatcher's drain

    # -- dispatcher ---------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _drain_on_stop(self) -> None:
        """Fail any requests that raced past close(): their Futures must
        resolve or the submitting handler blocks out its full timeout."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not _STOP:
                item[1].set_exception(RuntimeError("server shutting down"))

    def _collect(self):
        """Block for the first request, then linger up to max_wait_ms."""
        # Poll rather than block indefinitely: close() can legitimately
        # consume the _STOP sentinel (its post-join drain races a dispatcher
        # still inside a long infer_fn call), so the sentinel alone cannot
        # be the only exit path — _closed is the authoritative signal.
        while True:
            try:
                first = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if self._closed:
                    return None
        if first is _STOP or self._closed:
            if first is not _STOP:
                first[1].set_exception(RuntimeError("server shutting down"))
            self._drain_on_stop()
            return None
        group = [first]
        deadline = time.monotonic() + self._max_wait_s
        while len(group) < self._buckets[-1]:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is _STOP:
                self._q.put(_STOP)  # re-post so the loop exits next round
                break
            group.append(item)
        return group

    def _run(self) -> None:
        while True:
            group = self._collect()
            if group is None:
                return
            bucket = self._bucket_for(len(group))
            batch = np.zeros((bucket, self._size, self._size, 3), np.uint8)
            for i, (img, _) in enumerate(group):
                batch[i] = img
            try:
                t0 = time.monotonic()
                probs = np.asarray(self._infer(batch))
                dt_ms = (time.monotonic() - t0) * 1e3
                # contract check INSIDE the try: a malformed artifact output
                # must fail this group's futures, not kill the dispatcher
                # thread (which would leave every later submit hanging)
                if probs.ndim < 2 or probs.shape[0] < len(group):
                    raise RuntimeError(
                        f"infer returned shape {probs.shape} for a "
                        f"{bucket}-batch holding {len(group)} requests")
                rows = [probs[i] for i in range(len(group))]
            except Exception as exc:  # noqa: BLE001 — forwarded to callers
                with self._lock:
                    self._stats["errors"] += len(group)
                for _, fut in group:
                    fut.set_exception(exc)
                continue
            for (_, fut), row in zip(group, rows):
                fut.set_result(row)
            with self._lock:
                self._stats["requests"] += len(group)
                self._stats["batches"] += 1
                self._stats["bucket_hist"][bucket] += 1
                self._stats["occupancy_sum"] += len(group)
                self._stats["capacity_sum"] += bucket
                self._latencies.append(dt_ms)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # http.server replies in two TCP segments (header buffer, then body);
    # with Nagle on, the body segment waits for the client's delayed ACK —
    # a flat +40 ms on every keep-alive request (measured on the JAX
    # package's copy of this handler with a 0 ms mock model).
    disable_nagle_algorithm = True
    # Socket timeout (http.server applies it to the connection): without it
    # a client that sends headers but stalls mid-body parks this handler
    # thread in rfile.read() forever — each such connection leaks a thread
    # (slowloris). A stalled read raises socket.timeout (an OSError), which
    # the body-read try below turns into a 400.
    timeout = 30
    # self.server is the ModelServer below

    def _reply(self, code: int, payload: dict) -> None:
        if code >= 400:
            # error paths may not have consumed the request body; on an
            # HTTP/1.1 keep-alive connection the unread bytes would be
            # parsed as the NEXT request line — drop the connection instead
            self.close_connection = True
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        if self.path == "/healthz":
            self._reply(200, {"status": "ok", **self.server.contract})
        elif self.path == "/stats":
            self._reply(200, self.server.batcher.stats())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        if self.path != "/predict":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        size = self.server.contract["input_size"]
        try:
            length = int(self.headers.get("Content-Length", 0))
            # Bound the read: a negative length would block until the
            # client closes (rfile.read(-N) reads to EOF), and an absurd
            # one would balloon memory. 64 MiB >> any canonical image.
            if not 0 < length <= 64 << 20:
                raise ValueError(f"bad Content-Length {length}")
            raw = self.rfile.read(length)
            ctype = self.headers.get("Content-Type",
                                     "application/octet-stream")
            if ctype == "application/octet-stream":
                expect = size * size * 3
                if len(raw) != expect:
                    raise ValueError(
                        f"raw payload is {len(raw)} bytes; canonical "
                        f"uint8 ({size},{size},3) needs {expect}")
                img = np.frombuffer(raw, np.uint8).reshape(size, size, 3)
            else:
                from endoscopy_tpu_torch.data.pipeline import decode_canonical_bytes
                img = decode_canonical_bytes(raw, size)
        except (ValueError, OSError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        try:
            probs = self.server.batcher.submit(img).result(
                timeout=self.server.request_timeout_s)
        except Exception as exc:  # noqa: BLE001 — surfaced as HTTP 500
            # str(TimeoutError()) is "" — fall back to the class name so the
            # most latency-relevant failure is not a blank error payload
            self._reply(500, {"error": str(exc) or type(exc).__name__})
            return
        probs = np.asarray(probs, np.float64)
        k = int(np.argmax(probs))
        self._reply(200, {"pred": k, "max_prob": float(probs[k]),
                          "probs": probs.tolist()})

    def log_message(self, fmt, *args):  # quiet per-request access log
        pass


class ModelServer(ThreadingHTTPServer):
    """HTTP front + BucketBatcher over one exported artifact."""

    daemon_threads = True
    # listen(5) — socketserver's default backlog — drops SYNs whenever >5
    # connections arrive between accept() calls; the client kernel retries
    # after 1s, a p99 latency cliff under many closed-loop non-keep-alive
    # clients (measured on the JAX package's copy of this server with
    # tools/bench_serving.py --mock-ms 0). A larger backlog removes it.
    request_queue_size = 128

    def __init__(self, address, infer_fn, *, input_size: int,
                 num_classes: int, buckets: Sequence[int],
                 max_wait_ms: float, backend: str,
                 request_timeout_s: float = 120.0):
        super().__init__(address, _Handler)
        self.batcher = BucketBatcher(infer_fn, input_size,
                                     buckets=buckets,
                                     max_wait_ms=max_wait_ms)
        self.contract = {"input_size": int(input_size),
                         "num_classes": int(num_classes),
                         "buckets": [int(b) for b in sorted(set(buckets))],
                         "backend": backend}
        self.request_timeout_s = float(request_timeout_s)

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        self.batcher.close()


def make_server(model_path: str, host: str = "0.0.0.0", port: int = 8000,
                buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                max_wait_ms: float = 5.0, warmup: bool = True,
                log=print, device=None) -> ModelServer:
    """Load an exported artifact and build a ready-to-serve ModelServer.

    A pinned-batch artifact forces ``buckets = (pinned,)``. ``warmup=True``
    runs every bucket size on the device before the socket starts
    accepting, so no live request pays a first-call cost.
    """
    import torch

    from endoscopy_tpu_torch.device import resolve_device
    from endoscopy_tpu_torch.serve.export import load_exported

    dev = resolve_device(device)
    infer = load_exported(model_path, device=dev)
    if infer.batch is not None:
        buckets = (infer.batch,)
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    if warmup:
        for b in buckets:
            t0 = time.monotonic()
            infer(np.zeros((b, infer.input_size, infer.input_size, 3),
                           np.uint8))
            log(f"warmup: batch {b} ran in {time.monotonic() - t0:.2f}s")
    backend = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu")
    return ModelServer((host, port), infer,
                       input_size=infer.input_size,
                       num_classes=infer.num_classes,
                       buckets=buckets, max_wait_ms=max_wait_ms,
                       backend=backend)
