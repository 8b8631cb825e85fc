"""Rollout server for DPOT-family models (port of dpot_tpu/serve/server.py).

- One autoregressive rollout per batch under torch.inference_mode();
  requests are padded up to the nearest batch bucket (powers of two) so the
  device sees a few fixed shapes. On the card each (bucket, steps) runs as
  one CUDA graph, the counterpart of the JAX server's jitted scan: the
  first batch of a shape runs eagerly and is answered, then the rollout is
  captured; `start()` does so for every bucket at each warm-up step count.
  Each capture counts under "compiles", as the JAX server counts its
  compiles; on the CPU, which runs eagerly, the first use of each step
  count does. The graphs share one memory pool (the worker replays them one
  at a time) and each answer is copied to the host before the next replay.
- Micro-batching: concurrent requests within `max_wait_ms` are concatenated
  into one device batch.
- Transport: stdlib ThreadingHTTPServer; tensors travel as raw .npy bodies.

Endpoints:
  GET  /healthz            -> JSON {ok, model, params_m, buckets} (no auth)
  GET  /metrics            -> JSON request/latency/batching counters
  POST /rollout?steps=N    -> body: .npy array (B, H, W, T_in, C) float32,
                              or a bfloat16 .npy (half the request bytes;
                              numpy reads its descr as void-V2 and the
                              handler reinterprets the 16-bit words)
                              response: .npy (B, H, W, N*t_bundle, C),
                              float32 by default, float16 when the server
                              was started with response_dtype=float16
  POST /rollout?model=NAME&steps=N -> multi-model deployments route by name

bfloat16 on the host: numpy has no bfloat16 without ml_dtypes, so a bf16
wire keeps raw 16-bit words as np.int16 on the host and views them as
torch.bfloat16 once they are on the device.

Hardening: optional bearer-token auth for /rollout and /metrics; `steps`
validated against `max_steps`; request bodies capped at `max_body_bytes`;
`stop(drain=True)` finishes queued work; TLS via serve(ssl_certfile=...).
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Union

import numpy as np
import torch

from dpot_tpu_torch.ops.cuda import graphs
from dpot_tpu_torch.utils.device import resolve_device

_WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_RESPONSE = {"float32": torch.float32, "float16": torch.float16}

Request = Union[np.ndarray, torch.Tensor]


def _npy_bytes(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


class _Pending:
    __slots__ = ("x", "steps", "event", "result", "error")

    def __init__(self, x: np.ndarray, steps: int):
        self.x = x
        self.steps = steps
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None


class RolloutServer:
    """Owns the model, the micro-batcher and its worker thread."""

    def __init__(
        self,
        model: torch.nn.Module,
        t_bundle: int = 1,
        batch_buckets: tuple[int, ...] = (1, 2, 4, 8),
        max_wait_ms: float = 2.0,
        warmup_steps: tuple[int, ...] = (1,),
        max_steps: int = 64,
        auth_token: Optional[str] = None,
        max_body_bytes: int = 256 * 2**20,
        wire_dtype: str = "auto",
        response_dtype: str = "float32",
        device: str | torch.device | None = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.t_bundle = t_bundle
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.max_wait_ms = max_wait_ms
        self.max_steps = int(max_steps)
        self.auth_token = auth_token
        self.max_body_bytes = int(max_body_bytes)
        # request wire: under bf16 compute the model's first op casts x to
        # bf16 anyway, so a bf16 wire gives bit-identical results at half the
        # host->device bytes; "auto" ties the wire to the compute dtype
        if wire_dtype == "auto":
            wire_dtype = (
                "bfloat16" if getattr(model, "dtype", None) == torch.bfloat16
                else "float32"
            )
        if wire_dtype not in _WIRE:
            raise ValueError(f"wire_dtype {wire_dtype!r} not in auto|float32|bfloat16")
        self.wire_dtype = wire_dtype
        # response wire: float16 is cast ON DEVICE before the fetch (half the
        # device->host and HTTP bytes); the default keeps float32
        if response_dtype not in _RESPONSE:
            raise ValueError(f"response_dtype {response_dtype!r} not in float32|float16")
        self.response_dtype = response_dtype
        self._seen_steps: set[int] = set()
        self._graphed = self.device.type == "cuda"
        self._graphs = graphs.GraphCache()
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._holdover: list[_Pending] = []  # worker-owned deferred items
        self._stop = threading.Event()
        self._accepting = True
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self.n_params = sum(p.numel() for p in model.parameters())
        self._warmup_steps = warmup_steps
        self._mlock = threading.Lock()
        self._m = {
            "requests": 0, "errors": 0, "auth_failures": 0,
            "latency_ms_sum": 0.0, "batches": 0, "batch_items": 0,
            "padded_items": 0, "compiles": 0,
        }
        self._lat_ring: list[float] = []  # last 512 request latencies (ms)

    def _count(self, **deltas) -> None:
        with self._mlock:
            for k, v in deltas.items():
                self._m[k] += v

    def _record_latency(self, ms: float) -> None:
        with self._mlock:
            self._m["latency_ms_sum"] += ms
            self._lat_ring.append(ms)
            if len(self._lat_ring) > 512:
                del self._lat_ring[: len(self._lat_ring) - 512]

    # ---- wire --------------------------------------------------------

    def _to_wire(self, x: Request) -> np.ndarray:
        """Host array in the wire representation: float32, or the raw
        16-bit words of bfloat16 as int16. x is a numpy array, or a CPU
        torch tensor (the way an in-process caller hands over bfloat16)."""
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu()
        else:
            t = torch.from_numpy(np.ascontiguousarray(x))
        if self.wire_dtype == "bfloat16":
            return t.to(torch.bfloat16).view(torch.int16).numpy()
        return t.to(torch.float32).numpy()

    def _upload(self, xs: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(xs)).to(self.device)
        return x.view(torch.bfloat16) if self.wire_dtype == "bfloat16" else x

    # ---- compute -----------------------------------------------------

    def _eager_rollout(self, x: torch.Tensor, n_steps: int) -> torch.Tensor:
        """n_steps-step autoregressive rollout of a device batch x in the
        wire dtype: (B, H, W, n_steps*t_bundle, C) on the device in the
        response dtype."""
        tb = self.t_bundle
        ims = []
        carry = x
        for _ in range(n_steps):
            out = self.model(carry)
            im = out[0] if isinstance(out, tuple) else out
            ims.append(im)
            # the carry stays in the wire dtype: under a bf16 wire the
            # model would cast the fed-back frame to bf16 on its first op
            # anyway
            carry = torch.cat([carry[..., tb:, :], im.to(carry.dtype)], dim=-2)
        return torch.cat(ims, dim=-2).to(_RESPONSE[self.response_dtype])

    @torch.inference_mode()
    def _rollout(self, x: torch.Tensor, n_steps: int) -> np.ndarray:
        """The rollout of `_eager_rollout`, on the card as the graph of its
        (bucket, n_steps), returned on the host. The model serves in eval
        mode, in which its graphs were captured: one put back in train mode
        (whose BatchNorm would normalise with the batch's statistics and
        update its buffers) raises."""
        if self.model.training:
            raise RuntimeError("the served model is in train mode; serve it in eval mode")
        if not self._graphed:
            return self._eager_rollout(x, n_steps).cpu().numpy()
        captures = self._graphs.captures
        pred = self._graphs(lambda b: self._eager_rollout(b["x"], n_steps), {"x": x},
                            key=(n_steps,))
        self._count(compiles=self._graphs.captures - captures)
        return pred.cpu().numpy()

    def _note_steps(self, n_steps: int) -> None:
        if n_steps not in self._seen_steps:
            self._seen_steps.add(n_steps)
            if not self._graphed:
                self._count(compiles=1)

    def _bucket(self, b: int) -> int:
        for cap in self.batch_buckets:
            if b <= cap:
                return cap
        return self.batch_buckets[-1]

    def _run_batch(self, items: list[_Pending]) -> None:
        try:
            xs = np.concatenate([it.x for it in items], axis=0)
            b = xs.shape[0]
            steps = items[0].steps
            self._note_steps(steps)
            max_cap = self.batch_buckets[-1]
            if b > max_cap:
                # oversize request: run in max-bucket chunks
                chunks = []
                for lo in range(0, b, max_cap):
                    cx = xs[lo : lo + max_cap]
                    n = cx.shape[0]
                    if n < max_cap:
                        cx = np.concatenate(
                            [cx, np.repeat(cx[:1], max_cap - n, axis=0)], axis=0
                        )
                        self._count(padded_items=max_cap - n)
                    chunks.append(self._rollout(self._upload(cx), steps)[:n])
                pred_np = np.concatenate(chunks, axis=0)
            else:
                cap = self._bucket(b)
                if b < cap:  # pad to the bucket
                    pad = np.repeat(xs[:1], cap - b, axis=0)
                    xs = np.concatenate([xs, pad], axis=0)
                    self._count(padded_items=cap - b)
                pred_np = self._rollout(self._upload(xs), steps)[:b]
            self._count(batches=1, batch_items=b)
            off = 0
            for it in items:
                n = it.x.shape[0]
                it.result = pred_np[off : off + n]
                off += n
        except Exception as e:  # surface errors to every waiter
            for it in items:
                it.error = f"{type(e).__name__}: {e}"
        finally:
            for it in items:
                it.event.set()

    def _drain(self) -> None:
        holdover = self._holdover  # deferred to the NEXT round, in order
        # after _stop, keep going until BOTH holdover and the queue are
        # empty, so no accepted request is left blocked on its event
        while not self._stop.is_set() or holdover or not self._queue.empty():
            if holdover:
                first = holdover.pop(0)
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            items = [first]
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            cap = self.batch_buckets[-1]
            total = first.x.shape[0]
            # gather compatible requests until the bucket is full or the
            # wait runs out; others are deferred, never run ahead (FIFO)
            while total < cap and not holdover:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if (
                    nxt.steps == first.steps
                    and nxt.x.shape[1:] == first.x.shape[1:]
                    and total + nxt.x.shape[0] <= cap
                ):
                    items.append(nxt)
                    total += nxt.x.shape[0]
                else:
                    holdover.append(nxt)
            self._run_batch(items)

    # ---- lifecycle ---------------------------------------------------

    def start(self) -> None:
        # one batch per warm-up step count: of the largest bucket, and on
        # the card of every bucket, so that each one's graph is captured
        caps = self.batch_buckets if self._graphed else self.batch_buckets[-1:]
        m = self.model
        for s in self._warmup_steps:
            for cap in caps:
                shape = (cap, m.img_size, m.img_size, m.in_timesteps, m.in_channels)
                p = _Pending(self._to_wire(np.zeros(shape, np.float32)), s)
                self._run_batch([p])
                if p.error:
                    raise RuntimeError(f"warmup failed: {p.error}")
        self._worker.start()

    def stop(self, drain: bool = False) -> None:
        """Stop the worker. drain=True rejects new submissions, finishes
        everything already queued (queue and holdover), then joins."""
        self._accepting = False
        if drain:
            while not self._queue.empty() or self._holdover:
                time.sleep(0.01)
        self._stop.set()
        if drain and self._worker.is_alive():
            self._worker.join(timeout=30.0)

    def submit(self, x: Request, steps: int) -> np.ndarray:
        """Blocking rollout request (thread-safe). x: (B, H, W, T, C) as a
        numpy array or a CPU torch tensor (e.g. bfloat16)."""
        t0 = time.perf_counter()
        self._count(requests=1)
        try:
            if not self._accepting:
                raise RuntimeError("server is shutting down")
            if x.ndim != 5:
                raise ValueError(f"expected (B,H,W,T,C), got shape {tuple(x.shape)}")
            # only the batch dim may vary (bucketed)
            m = self.model
            want = (m.img_size, m.img_size, m.in_timesteps, m.in_channels)
            if tuple(x.shape[1:]) != want:
                raise ValueError(
                    f"input shape {tuple(x.shape[1:])} != served model's "
                    f"(H,W,T,C)={want}"
                )
            if x.shape[0] < 1:
                raise ValueError("batch must be >= 1")
            steps = int(steps)
            if not 1 <= steps <= self.max_steps:
                raise ValueError(
                    f"steps={steps} outside [1, {self.max_steps}] "
                    "(configure max_steps to raise the cap)"
                )
            # wire conversion in the HANDLER thread, overlapping the
            # worker's current device batch
            p = _Pending(self._to_wire(x), steps)
            self._queue.put(p)
            # liveness-checked wait: fail instead of blocking forever if
            # the worker exited
            while not p.event.wait(timeout=1.0):
                if not self._worker.is_alive() and not p.event.is_set():
                    raise RuntimeError("server stopped before the request completed")
            if p.error:
                raise RuntimeError(p.error)
            return p.result
        except Exception:
            self._count(errors=1)
            raise
        finally:
            self._record_latency((time.perf_counter() - t0) * 1e3)

    def resolve(self, name: str) -> "Optional[RolloutServer]":
        """A single-model server only serves unnamed requests."""
        return self if not name else None

    def health(self) -> dict:
        return {
            "ok": True,
            "model": type(self.model).__name__,
            "params_m": round(self.n_params / 1e6, 2),
            "buckets": list(self.batch_buckets),
            "compiled_steps": sorted(self._seen_steps),
            "wire_dtype": self.wire_dtype,
            "response_dtype": self.response_dtype,
            "device": str(self.device),
        }

    def metrics(self) -> dict:
        with self._mlock:
            m = dict(self._m)
            lat = sorted(self._lat_ring)
        n = max(m["requests"], 1)
        items = max(m["batch_items"], 1)
        out = {
            **m,
            "latency_ms_avg": round(m["latency_ms_sum"] / n, 3),
            # fraction of device-batch slots that carried real requests
            "bucket_fill_rate": round(
                m["batch_items"] / (m["batch_items"] + m["padded_items"] or 1), 4
            ),
            "requests_per_batch": round(items / max(m["batches"], 1), 3),
            "compiled_steps": len(self._seen_steps),
            "queue_depth": self._queue.qsize(),
            "accepting": self._accepting,
        }
        if lat:
            out["latency_ms_p50"] = round(lat[len(lat) // 2], 3)
            out["latency_ms_p95"] = round(lat[int(len(lat) * 0.95) - 1], 3)
        return out


class ModelRouter:
    """Routes requests across named RolloutServers (one process, N models,
    each with its own queue, worker and buckets). `default` serves requests
    that name no model."""

    def __init__(
        self,
        servers: dict[str, RolloutServer],
        default: Optional[str] = None,
        auth_token: Optional[str] = None,
    ):
        if not servers:
            raise ValueError("ModelRouter needs at least one model")
        self.servers = dict(servers)
        self.default = default if default is not None else next(iter(servers))
        if self.default not in self.servers:
            raise ValueError(f"default model {self.default!r} not in {sorted(servers)}")
        self.auth_token = auth_token
        # the loosest member's cap, so routing never rejects a request its
        # target would have accepted
        self.max_body_bytes = max(s.max_body_bytes for s in servers.values())
        self._auth_failures = 0

    def resolve(self, name: str) -> Optional[RolloutServer]:
        return self.servers.get(name or self.default)

    def start(self) -> None:
        for s in self.servers.values():
            s.start()

    def stop(self, drain: bool = False) -> None:
        for s in self.servers.values():
            s.stop(drain=drain)

    def _count(self, **deltas) -> None:
        # auth failures happen before routing; keep a router-level count
        self._auth_failures += deltas.get("auth_failures", 0)

    def health(self) -> dict:
        return {
            "ok": True,
            "models": {n: s.health() for n, s in self.servers.items()},
            "default": self.default,
        }

    def metrics(self) -> dict:
        out = {n: s.metrics() for n, s in self.servers.items()}
        out["auth_failures_unrouted"] = self._auth_failures
        return out


def _make_handler(server: "RolloutServer | ModelRouter"):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authed(self) -> bool:
            """Bearer-token check (skipped when no token is configured)."""
            if server.auth_token is None:
                return True
            import hmac

            got = self.headers.get("Authorization", "")
            # compare bytes: compare_digest on str raises for non-ASCII input
            if hmac.compare_digest(
                got.encode("utf-8", "surrogateescape"),
                f"Bearer {server.auth_token}".encode("utf-8"),
            ):
                return True
            server._count(auth_failures=1)
            self._json(401, {"error": "missing or invalid bearer token"})
            return False

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/healthz":
                self._json(200, server.health())
            elif path == "/metrics":
                if self._authed():
                    self._json(200, server.metrics())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            if url.path != "/rollout":
                self._json(404, {"error": "unknown path"})
                return
            if not self._authed():
                return
            try:
                q = urllib.parse.parse_qs(url.query)
                steps = int(q.get("steps", ["1"])[0])
                mname = q.get("model", [""])[0]
                target = server.resolve(mname)
                if target is None:
                    self._json(404, {"error": f"unknown model {mname!r}"})
                    return
                n = int(self.headers.get("Content-Length", "0"))
                if n > server.max_body_bytes:
                    self._json(
                        413,
                        {"error": f"body {n} bytes exceeds "
                                  f"max_body_bytes={server.max_body_bytes}"},
                    )
                    return
                x = np.load(io.BytesIO(self.rfile.read(n)))
                if x.dtype.kind == "V" and x.dtype.itemsize == 2:
                    # a bfloat16 .npy: numpy reads its descr as void-V2;
                    # reinterpret the 16-bit words as bfloat16
                    x = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
                pred = target.submit(x, steps)
                body = _npy_bytes(pred)
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(
    model: torch.nn.Module,
    host: str = "127.0.0.1",
    port: int = 8476,
    ssl_certfile: Optional[str] = None,
    ssl_keyfile: Optional[str] = None,
    **kw,
) -> tuple[ThreadingHTTPServer, RolloutServer]:
    """Start the rollout server; returns (httpd, rollout_server). The caller
    owns shutdown: httpd.shutdown(); rollout_server.stop(drain=True).
    kw go to RolloutServer (device defaults to cuda)."""
    rs = RolloutServer(model, **kw)
    return _listen(rs, host, port, ssl_certfile, ssl_keyfile), rs


def serve_multi(
    servers: "dict[str, RolloutServer]",
    default: Optional[str] = None,
    auth_token: Optional[str] = None,
    host: str = "127.0.0.1",
    port: int = 8476,
    ssl_certfile: Optional[str] = None,
    ssl_keyfile: Optional[str] = None,
) -> tuple[ThreadingHTTPServer, ModelRouter]:
    """Start a multi-model rollout server: POST /rollout?model=<name> routes
    to the named RolloutServer. The caller owns shutdown."""
    router = ModelRouter(servers, default=default, auth_token=auth_token)
    return _listen(router, host, port, ssl_certfile, ssl_keyfile), router


def _listen(target, host, port, ssl_certfile, ssl_keyfile) -> ThreadingHTTPServer:
    target.start()
    httpd = ThreadingHTTPServer((host, port), _make_handler(target))
    if ssl_certfile:
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(ssl_certfile, ssl_keyfile)
        httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
