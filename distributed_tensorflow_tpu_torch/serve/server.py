"""Stdlib-only HTTP front end for the serving scheduler.

This package's copy of ``distributed_tensorflow_tpu/serve/server.py`` on
this package's scheduler: the same endpoints, JSON keys, status codes and
``Retry-After`` headers. Handler threads only ``submit()`` and wait on the
returned handle; the engine (and with it every device call) stays on the
scheduler's driver thread.

* ``POST /generate`` — body ``{"prompt": [ints] | "text", "max_new_tokens",
  "temperature", "top_k", "top_p", "seed", "eos_id", "deadline_s",
  "priority", "client_id", "stream"}``. Completion → 200 ``request_id,
  tokens, text?, ttft_ms, latency_ms, finish_reason, variant,
  weight_version``; rejections ``queue_full`` → 429, ``deadline`` /
  ``shutting_down`` / a result timeout → 503, ``invalid`` and bad JSON →
  400, each 429/503 with ``Retry-After``. With ``"stream": true`` the
  accepted path is Server-Sent Events: ``event: token`` frames of
  ``{"tokens": [ints]}``, closed by one ``event: done`` frame carrying the
  non-streaming 200's JSON (or the rejection).
* ``GET /healthz`` — 200 ``{"ok": true, ...}`` while serving, 503 once the
  scheduler stops accepting or its started loop thread died.
* ``GET /metrics`` — Prometheus text; ``GET /metrics.json`` — the
  ``ServingMetrics.snapshot()`` JSON.
* ``GET /slo.json``, ``POST /handoff``, ``POST /admin/handoff_peers`` and
  ``POST /admin/deploy`` answer as the JAX server does with those features
  off (no SLO monitor, no handoff support or outbox, no variant table or
  weight swapper): SLO monitors, handoff and deploy are not ported yet.

Fault sites (``utils/faults.py``): ``replica_stall``, ``replica_hang`` and
``replica_5xx`` on ``/generate`` before admission, ``stream_cut`` per SSE
token frame.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from distributed_tensorflow_tpu_torch.obs import export as obs_export
from distributed_tensorflow_tpu_torch.serve.scheduler import Completion, Request
from distributed_tensorflow_tpu_torch.utils import faults

__all__ = ["make_server"]

_REJECTION_STATUS = {
    "queue_full": 429,
    "deadline": 503,
    "shutting_down": 503,
    "invalid": 400,
    # Disaggregated tiers: both are retryable-elsewhere conditions — the
    # pushing prefill replica tries another decode peer or decodes
    # locally (insufficient_pages), or surfaces the typed loss of a
    # decode peer mid-stream (upstream_died).
    "insufficient_pages": 503,
    "upstream_died": 503,
}


def _parse_request(body: dict, codec, budget_s: float | None = None) -> Request:
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        if codec is None:
            raise ValueError("string prompt needs a server-side codec")
        prompt = codec.encode(prompt)
    if not isinstance(prompt, (list, tuple)) or not prompt:
        raise ValueError("prompt must be a non-empty list of token ids")
    if not all(isinstance(t, int) and not isinstance(t, bool) for t in prompt):
        raise ValueError("prompt tokens must be ints")
    eos_id = body.get("eos_id")
    deadline = body.get("deadline_s")
    deadline = None if deadline is None else float(deadline)
    if budget_s is not None:
        # Propagated router budget (X-Budget-Ms): the remaining END-TO-END
        # time. The scheduler's deadline_s is a queue-wait budget, so the
        # min is conservative — a request the router can no longer finish
        # must not sit in the admission queue either.
        deadline = budget_s if deadline is None else min(deadline, budget_s)
    priority = body.get("priority", 1)
    if isinstance(priority, bool) or not isinstance(priority, int):
        raise ValueError(f"priority must be an int lane, got {priority!r}")
    return Request(
        prompt=tuple(prompt),
        max_new_tokens=int(body.get("max_new_tokens", 16)),
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 0.0)),
        seed=int(body.get("seed", 0)),
        eos_id=None if eos_id is None else int(eos_id),
        deadline_s=None if deadline is None else float(deadline),
        request_id=str(body.get("request_id", "")),
        priority=priority,
        client_id=str(body.get("client_id", "")),
        stream=bool(body.get("stream", False)),
        variant=str(body.get("variant", "")),
    )


def make_server(
    scheduler,
    host: str = "127.0.0.1",
    port: int = 8000,
    *,
    request_timeout_s: float = 60.0,
    codec=None,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; caller runs ``serve_forever()``
    and owns scheduler start/stop. ``port=0`` binds an ephemeral port
    (tests read ``server.server_address``)."""

    class Handler(BaseHTTPRequestHandler):
        # Serving logs go through metrics, not per-request stderr lines.
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, payload: dict, headers=None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(data)

        def _send_rejection(self, outcome) -> None:
            status = _REJECTION_STATUS.get(outcome.reason, 500)
            body = {
                "error": outcome.reason,
                "detail": outcome.detail,
                "request_id": outcome.request_id,
            }
            headers = {}
            if status in (429, 503):
                retry_after = 1
                if outcome.reason == "shutting_down":
                    remaining = None
                    drain_fn = getattr(scheduler, "drain_remaining_s", None)
                    if drain_fn is not None:
                        remaining = drain_fn()
                    if remaining is not None:
                        # Tell callers how long this replica keeps draining
                        # before it is gone for good.
                        body["drain_deadline_s"] = round(remaining, 3)
                        retry_after = max(1, int(remaining) + 1)
                    else:
                        # Stopping with no announced deadline: assume gone.
                        retry_after = 30
                headers["Retry-After"] = str(retry_after)
            self._send(status, body, headers)

        def _send_text(self, code: int, text: str) -> None:
            data = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                accepting = getattr(scheduler, "accepting", True)
                thread = getattr(scheduler, "_thread", None)
                # A never-started scheduler (driven externally via step())
                # is healthy; a STARTED loop whose thread died is not.
                loop_ok = thread is None or thread.is_alive()
                ok = bool(accepting and loop_ok)
                body = {
                    "ok": ok,
                    "accepting": bool(accepting),
                    "loop_running": scheduler.loop_running,
                    "slots": scheduler.engine.slots,
                    "free_slots": scheduler.engine.free_slots,
                    "queue_depth": scheduler.queue_depth,
                    "draining": bool(getattr(scheduler, "draining", False)),
                    # Disaggregated-tier role (prefill|decode|mixed):
                    # probes carry it into the registry so the router
                    # steers fresh prompts at the prefill tier.
                    "role": str(getattr(scheduler, "role", "mixed")),
                    # Mesh topology: a tp-wide sharded replica is ONE
                    # replica spanning N devices, not N independent ones —
                    # the router must not multiply its capacity by tp.
                    "mesh": {
                        "tp": int(getattr(scheduler.engine, "tp", 1)),
                        "devices": int(
                            getattr(scheduler.engine, "mesh_device_count", 1)
                        ),
                    },
                    # Weight quantization mode ('native'/'int8'/'int4') —
                    # the router tells quantized variants apart by this.
                    "weight_dtype": str(
                        getattr(scheduler.engine, "weight_dtype", "native")
                    ),
                    # KV ACTIVATION format ('bf16'/'int8') — a prefill tier
                    # must only hand pages to a decode tier with the same
                    # format, so probes carry it into the registry.
                    "kv_dtype": str(
                        getattr(scheduler.engine, "kv_dtype", "bf16")
                    ),
                }
                if getattr(scheduler.engine, "paged", False):
                    # Page capacity is the real admission gate under the
                    # paged KV layout — routers dispatching on free_slots
                    # alone would overfill an oversubscribed pool.
                    pool = scheduler.engine.pool
                    body["pages_free"] = pool.pages_free
                    body["pages_total"] = pool.pages_allocatable
                # Deploy state: which checkpoint step is live and which
                # variants this replica can serve — the fleet registry
                # reads this to route variant-pinned traffic.
                deploy = {
                    "weight_version": int(
                        getattr(scheduler.engine, "weight_version", 0)
                    ),
                    "serving_variant": str(
                        getattr(scheduler.engine, "serving_variant", "")
                    ),
                }
                variants = getattr(scheduler, "variants", None)
                if variants is not None:
                    deploy.update(variants.snapshot())
                # Last swap outcome: the rollout controller polls this to
                # tell "swap landed live" from "canary rolled it back".
                last = getattr(getattr(scheduler, "swapper", None),
                               "last", None)
                if last is not None:
                    deploy["last_swap"] = last.to_dict()
                body["deploy"] = deploy
                drain_fn = getattr(scheduler, "drain_remaining_s", None)
                remaining = drain_fn() if drain_fn is not None else None
                if remaining is not None:
                    body["drain_remaining_s"] = round(remaining, 3)
                self._send(200 if ok else 503, body)
            elif self.path == "/slo.json":
                self._send(200, {"enabled": False})  # no SLO monitor: not ported yet
            elif self.path == "/metrics":
                if scheduler.metrics is None:
                    self._send_text(200, "")
                else:
                    self._send_text(
                        200,
                        obs_export.prometheus_text(scheduler.metrics.registry),
                    )
            elif self.path == "/metrics.json":
                snap = (scheduler.metrics.snapshot()
                        if scheduler.metrics is not None else {})
                self._send(200, snap)
            else:
                self._send(404, {"error": "not_found", "detail": self.path})

        def do_POST(self):
            if self.path == "/handoff":
                self._handle_handoff()
                return
            if self.path == "/admin/handoff_peers":
                self._handle_handoff_peers()
                return
            if self.path == "/admin/deploy":
                self._handle_admin_deploy()
                return
            if self.path != "/generate":
                self._send(404, {"error": "not_found", "detail": self.path})
                return
            # Chaos sites (DESIGN.md §22), armable via DTT_FAULT alone.
            stall = faults.delay_s("replica_stall")
            if stall:
                time.sleep(stall)
            if faults.fire("replica_hang"):
                # Hold the socket without answering — the stuck-socket
                # failure mode (process alive, healthz fine, request path
                # wedged). The caller's read timeout, not this server,
                # must turn it into a typed outcome. Handler threads are
                # daemons; the hold is bounded by the site's ms.
                time.sleep(faults.site_ms("replica_hang", 30_000.0) / 1e3)
                self.close_connection = True
                return
            if faults.fire("replica_5xx"):
                self._send(503, {"error": "injected_5xx",
                                 "detail": "DTT_FAULT replica_5xx"},
                           {"Retry-After": "1"})
                return
            budget_s = None
            raw_budget = self.headers.get("X-Budget-Ms")
            if raw_budget is not None:
                try:
                    budget_s = max(0.0, float(raw_budget) / 1000.0)
                except ValueError:
                    budget_s = None
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                request = _parse_request(body, codec, budget_s=budget_s)
            except (ValueError, TypeError, json.JSONDecodeError) as exc:
                self._send(400, {"error": "invalid", "detail": str(exc)})
                return
            pending = scheduler.submit(request)
            if request.stream:
                self._stream_response(pending)
                return
            try:
                outcome = pending.result(timeout=request_timeout_s)
            except TimeoutError as exc:
                self._send(503, {"error": "timeout", "detail": str(exc)})
                return
            if isinstance(outcome, Completion):
                # Attribution headers: which variant/weights served this
                # request (the router relays them; loadgen splits its
                # report by them).
                self._send(200, self._completion_payload(outcome), {
                    "X-Variant": outcome.variant,
                    "X-Weight-Version": str(outcome.weight_version),
                })
            else:
                self._send_rejection(outcome)

        def _handle_handoff(self) -> None:
            """POST /handoff with no handoff support: 404."""
            self._send(404, {"error": "not_found", "detail": "no handoff support"})

        def _handle_handoff_peers(self) -> None:
            """POST /admin/handoff_peers on a replica without an outbox."""
            self._send(400, {"error": "invalid",
                             "detail": "replica has no handoff outbox "
                                       "(role is not prefill)"})

        def _handle_admin_deploy(self) -> None:
            """POST /admin/deploy on a replica with no variant table and no
            weight swapper: an empty body is a no-op 200, either plane 400."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, TypeError, json.JSONDecodeError) as exc:
                self._send(400, {"error": "invalid", "detail": str(exc)})
                return
            if "canary_percent" in body:
                self._send(400, {"error": "invalid", "detail": "replica has no variant table"})
                return
            if "step" in body:
                self._send(400, {"error": "invalid", "detail": "replica has no weight swapper"})
                return
            self._send(200, {"ok": True})

        def _completion_payload(self, outcome: Completion) -> dict:
            payload = {
                "request_id": outcome.request_id,
                "tokens": list(outcome.tokens),
                "ttft_ms": outcome.ttft_s * 1e3,
                "latency_ms": outcome.latency_s * 1e3,
                "finish_reason": outcome.finish_reason,
                "variant": outcome.variant,
                "weight_version": outcome.weight_version,
            }
            if codec is not None:
                payload["text"] = codec.decode(list(outcome.tokens))
            return payload

        def _write_event(self, event: str, obj: dict) -> None:
            frame = f"event: {event}\ndata: {json.dumps(obj)}\n\n".encode()
            self.wfile.write(frame)
            self.wfile.flush()  # per-event: nothing downstream may batch

        def _stream_response(self, pending) -> None:
            """SSE leg of /generate. The first event decides the shape:
            a synchronous rejection stays a plain JSON error response
            (clients branch on status, not on stream content); once a
            token exists we commit to 200 + event-stream and every
            terminal outcome — including a mid-queue shed — arrives as
            the final ``done`` frame."""
            events = pending.stream_events(timeout=request_timeout_s)
            try:
                kind, payload = next(events)
            except TimeoutError as exc:
                self._send(503, {"error": "timeout", "detail": str(exc)})
                return
            if kind == "done" and not isinstance(payload, Completion):
                self._send_rejection(payload)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-Accel-Buffering", "no")
            # Streams commit headers before completion: the variant was
            # pinned at submit, so it is already exact; the final `done`
            # frame carries the full attribution (incl. weight_version).
            self.send_header("X-Variant", getattr(pending, "variant", ""))
            # No Content-Length on purpose: HTTP/1.0 close-delimited body,
            # so proxies cannot wait for "the whole response".
            self.end_headers()
            try:
                while True:
                    if kind == "tokens":
                        if faults.fire("stream_cut"):
                            # Close without a done frame: the truncated
                            # stream is exactly what a mid-generation
                            # replica death looks like on the wire
                            # (``stream_cut:after=N`` lets N frames pass).
                            self.close_connection = True
                            return
                        self._write_event("token", {"tokens": payload})
                        kind, payload = next(events)
                        continue
                    if isinstance(payload, Completion):
                        self._write_event(
                            "done", self._completion_payload(payload))
                    else:
                        self._write_event("done", {
                            "error": payload.reason,
                            "detail": payload.detail,
                            "request_id": payload.request_id,
                        })
                    return
            except TimeoutError:
                # Stream went quiet past the deadline: surface in-band,
                # then close — the truncated stream is the error signal.
                try:
                    self._write_event("error", {"error": "timeout"})
                except OSError:
                    pass
            except (BrokenPipeError, ConnectionResetError):
                pass  # client left; the scheduler still finishes the slot

    return ThreadingHTTPServer((host, port), Handler)
