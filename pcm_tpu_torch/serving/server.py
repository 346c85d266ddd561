"""Request-batching HTTP server over an InferenceEngine (counterpart of
`pcm_tpu/serving/server.py`). Standard library only.

API:
  GET  /healthz    -> {"ok": true, "stats": {...}}
  GET  /stats      -> latency percentiles, throughput, batch occupancy
  POST /generate   {"prompt": str, "seed": int?, "adapter": str?}
                   -> {"image_b64": png, "batch_size": n, "latency_ms": t}
  POST /lora       {"path": str, "name": str?} -> without "name": swap the
                   default adapter for a kohya .safetensors file (batches in
                   flight finish on the old one); with "name": register it for
                   requests' "adapter". A bad path or a file that does not fit
                   the engine's adapter answers 400 and changes nothing.
  DELETE /lora/<name>  -> unregister a named adapter

A single dispatcher thread coalesces requests for the same adapter into one
device batch, dispatching a bucket when it is full or when its oldest
request has waited ``max_wait_ms``.
"""

from __future__ import annotations

import base64
import collections
import json
import os
import queue
import struct
import threading
import time
import zlib
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .engine import InferenceEngine


def png_bytes(img: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 image as PNG (8-bit RGB, no filtering)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class _Pending:
    __slots__ = ("prompt", "seed", "adapter", "future", "t0")

    def __init__(self, prompt: str, seed: int, adapter: Optional[str] = None):
        self.prompt = prompt
        self.seed = seed
        self.adapter = adapter
        self.future: Future = Future()
        self.t0 = time.monotonic()


class BatchingServer:
    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1", port: int = 0,
                 max_wait_ms: float = 50.0):
        self.engine = engine
        self.max_wait_s = max_wait_ms / 1000.0
        self._lat_ms: "collections.deque[float]" = collections.deque(maxlen=2048)
        self._occupancy: "collections.deque[int]" = collections.deque(maxlen=512)
        self._errors = 0
        self._t_start = time.monotonic()
        self._stats_lock = threading.Lock()
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._serve_thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    @property
    def address(self):
        return self._httpd.server_address  # (host, port), port resolved if 0

    def start(self) -> None:
        self._dispatcher.start()
        self._serve_thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._queue.put(None)
        self._dispatcher.join(timeout=60)

    def serve_forever(self) -> None:
        self.start()
        self._serve_thread.join()

    # -- batching core ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        b = self.engine.cfg.batch_size
        buckets: "dict[Optional[str], list]" = {}
        while True:
            timeout = None
            if buckets:
                oldest = min(bk[0].t0 for bk in buckets.values())
                timeout = oldest + self.max_wait_s - time.monotonic()
                if timeout <= 0:
                    name = min(buckets, key=lambda k: buckets[k][0].t0)
                    self._run(buckets.pop(name))
                    continue
            try:
                nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                continue
            if nxt is None:
                for batch in buckets.values():
                    self._run(batch)
                return
            buckets.setdefault(nxt.adapter, []).append(nxt)
            if len(buckets[nxt.adapter]) >= b:
                self._run(buckets.pop(nxt.adapter))

    def _run(self, batch) -> None:
        try:
            imgs = self.engine.generate_batch([p.prompt for p in batch],
                                              [p.seed for p in batch], adapter=batch[0].adapter)
            done = time.monotonic()
            for p, img in zip(batch, imgs):
                p.future.set_result((img, len(batch)))
            with self._stats_lock:
                self._occupancy.append(len(batch))
                for p in batch:
                    self._lat_ms.append((done - p.t0) * 1000.0)
        except Exception as e:  # the dispatcher must keep serving: hand the error to every waiter
            with self._stats_lock:
                self._errors += 1
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(e)

    def stats(self) -> dict:
        with self._stats_lock:
            lats = sorted(self._lat_ms)
            occ = list(self._occupancy)
            errors = self._errors
        uptime = time.monotonic() - self._t_start

        def pct(q: float) -> Optional[float]:
            return round(lats[min(len(lats) - 1, int(q * len(lats)))], 1) if lats else None

        eng = dict(self.engine.stats)
        return {
            **eng,
            "lora": self.engine.lora_source,
            "swaps": eng["lora_swaps"],
            "errors": errors,
            "uptime_s": round(uptime, 1),
            "requests_per_s": round(eng.get("requests", 0) / max(uptime, 1e-9), 3),
            "latency_ms": {"p50": pct(0.5), "p90": pct(0.9), "p99": pct(0.99)},
            "batch_occupancy": round(sum(occ) / (len(occ) * self.engine.cfg.batch_size), 3)
            if occ else None,
            "window": len(lats),
        }

    # -- http ---------------------------------------------------------------

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length) or b"{}")

            def _post_lora(self):
                try:
                    req = self._body()
                    path, name = req["path"], req.get("name")
                    if not isinstance(path, str) or not os.path.isfile(path):
                        raise FileNotFoundError(path)
                    if name is not None:
                        outer.engine.register_adapter(name, path)
                    else:
                        outer.engine.load_lora(path)
                except (KeyError, ValueError, OSError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                except Exception as e:  # not the client's fault: a device or loader failure
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._json(200, {"ok": True, "lora": outer.engine.lora_source,
                                 "adapters": outer.engine.adapter_names,
                                 "swaps": outer.engine.stats["lora_swaps"]})

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True, "stats": outer.engine.stats})
                elif self.path == "/stats":
                    self._json(200, outer.stats())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_DELETE(self):
                if not self.path.startswith("/lora/"):
                    self._json(404, {"error": "unknown path"})
                    return
                try:
                    outer.engine.unregister_adapter(self.path[len("/lora/"):])
                except KeyError as e:
                    self._json(404, {"error": f"{e}"})
                    return
                self._json(200, {"ok": True, "adapters": outer.engine.adapter_names})

            def do_POST(self):
                if self.path == "/lora":
                    self._post_lora()
                    return
                if self.path != "/generate":
                    self._json(404, {"error": "unknown path"})
                    return
                try:
                    req = self._body()
                    prompt = req["prompt"]
                    seed = int(req.get("seed", 0))
                    adapter = req.get("adapter")
                    if adapter is not None and adapter not in outer.engine.adapters:
                        raise KeyError(f"unknown adapter {adapter!r}")
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                pending = _Pending(prompt, seed, adapter)
                outer._queue.put(pending)
                try:
                    img, bsz = pending.future.result(timeout=600)
                except Exception as e:  # engine failure: report it to this client
                    self._json(500, {"error": str(e)})
                    return
                self._json(200, {
                    "image_b64": base64.b64encode(png_bytes(img)).decode(),
                    "batch_size": bsz,
                    "latency_ms": round((time.monotonic() - pending.t0) * 1000, 1),
                })

        return Handler
