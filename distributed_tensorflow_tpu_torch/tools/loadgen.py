"""Load generator for the serving stack: closed- and open-loop arrival —
the port of ``tools/loadgen.py``.

* ``--url http://host:port`` hits a running ``cli/serve_lm.py`` (of either
  package) over HTTP; ``--targets a,b,...`` sprays several replicas
  round-robin. ``--stream`` switches HTTP submits to SSE and measures TTFT
  at the client (the wall arrival of the first token frame). Without a
  target it self-serves: builds the stack in-process through the port's
  ``cli/serve_lm.py::build_stack`` (demo weights from seed 0, or
  ``--model`` a bundle) and submits straight to the scheduler, on the card
  unless ``--device cpu``.
* Closed loop (default): ``--concurrency`` workers, each submitting its
  next request the moment the previous one finishes. Open loop
  (``--rate R``): requests fire on a fixed schedule of R req/s whatever
  completes, so admission control must shed. ``--shape
  diurnal|burst|step`` makes the open loop a piecewise rate schedule and
  splits p50/p95/p99 per phase.

Every request lands in exactly one bucket: completed, shed (typed
rejection / HTTP 4xx-5xx with a structured body) or errored (transport
failure, malformed answer). ``--smoke`` exits nonzero if that last bucket
is non-empty or nothing completed. The report — the JAX tool's keys — is
the last stdout line, and one JSONL line appended to ``--report_file``.
The fleet scrapes (the handoff funnel, ``--handoff_report``, and the
rollout counters) are not ported yet.

    python -m distributed_tensorflow_tpu_torch.tools.loadgen --device cpu --smoke \
        --num_requests 16 --concurrency 4 --report_file ''
    python -m distributed_tensorflow_tpu_torch.tools.loadgen --url http://127.0.0.1:8000 \
        --rate 20 --stream --smoke
"""

import argparse
import json
import sys
import threading
import time

_NOT_PORTED = "is not ported yet"


def _percentiles(xs):
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    xs = sorted(xs)

    def pick(q):
        i = min(len(xs) - 1, max(0, round(q / 100 * (len(xs) - 1))))
        return xs[i]

    return {"p50": pick(50), "p95": pick(95), "p99": pick(99)}


class _Accounting:
    """Every submitted request lands in exactly one bucket. When the
    target is a fleet router, the X-Replica / X-Attempts response headers
    additionally attribute each answer to the replica that produced it
    and count failovers (attempts beyond the first)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.completed = 0
        self.shed = 0
        self.errored = 0
        # Streams that delivered tokens but no terminal frame: a TYPED,
        # visible failure (the truncation is the signal — the router
        # never retries a partial stream), distinct from the silent-drop
        # bucket ``errored``.
        self.stream_aborted = 0
        self.tokens = 0
        self.ttft_s = []
        self.latency_s = []
        self.intertoken_s = []
        self.shed_reasons = {}
        self.per_replica = {}
        self.failovers = 0
        # Per-attempt attribution (X-Attempt-Trail), bounded — chaos runs
        # read these from the JSONL to see which replica failed how.
        self.trails = []
        # Deploy attribution, keyed by the X-Variant response header
        # ("" = single-variant serving): per-variant latency samples +
        # token counts, and every weight version observed per variant —
        # a hot swap mid-run shows up as two versions under one variant.
        self.per_variant = {}
        # Traffic-shape attribution: outcome + latency samples per
        # schedule phase ("burst", "trough", ...) when --shape is set.
        self.per_phase = {}
        # Rollout attribution: per-replica weight-version TIMELINE —
        # an (elapsed_s, version) point appended whenever the version a
        # replica's answers carry changes (X-Replica + X-Weight-Version
        # headers). A fleet walk shows up as staggered per-replica
        # steps; a fleet rollback as steps back down.
        self.t0 = time.monotonic()
        self.replica_versions = {}

    def _phase_bucket(self, phase):
        return self.per_phase.setdefault(phase, {
            "completed": 0, "shed": 0, "errored": 0, "stream_aborted": 0,
            "tokens": 0, "ttft_s": [], "latency_s": [],
        })

    def complete(self, ttft_s, latency_s, n_tokens, gaps=None,
                 variant=None, weight_version=None, phase=None):
        """``gaps``: measured inter-token gaps (SSE frame arrivals). When
        absent, the decode-phase mean (latency - ttft) / (n - 1) stands in
        — per-request, so the percentile spread across requests survives."""
        with self.lock:
            self.completed += 1
            self.tokens += n_tokens
            self.ttft_s.append(ttft_s)
            self.latency_s.append(latency_s)
            if gaps:
                self.intertoken_s.extend(gaps)
            elif n_tokens > 1 and latency_s > ttft_s >= 0:
                self.intertoken_s.append(
                    (latency_s - ttft_s) / (n_tokens - 1))
            if variant is not None:
                v = self.per_variant.setdefault(variant, {
                    "completed": 0, "tokens": 0, "ttft_s": [],
                    "latency_s": [], "weight_versions": set(),
                })
                v["completed"] += 1
                v["tokens"] += n_tokens
                v["ttft_s"].append(ttft_s)
                v["latency_s"].append(latency_s)
                if weight_version is not None:
                    v["weight_versions"].add(int(weight_version))
            if phase is not None:
                b = self._phase_bucket(phase)
                b["completed"] += 1
                b["tokens"] += n_tokens
                b["ttft_s"].append(ttft_s)
                b["latency_s"].append(latency_s)

    def variant_report(self):
        """JSON-ready per-variant split (p50/p95/p99 + token parity)."""
        with self.lock:
            return {
                name: {
                    "completed": v["completed"],
                    "tokens": v["tokens"],
                    "weight_versions": sorted(v["weight_versions"]),
                    "ttft_ms": {k: round(x * 1e3, 3) for k, x in
                                _percentiles(v["ttft_s"]).items()},
                    "latency_ms": {k: round(x * 1e3, 3) for k, x in
                                   _percentiles(v["latency_s"]).items()},
                }
                for name, v in sorted(self.per_variant.items())
            }

    def rollout_report(self):
        """JSON-ready rollout view: the weight-version timeline each
        replica's answers traced out, plus every version observed
        anywhere in the run (headers or done frames)."""
        with self.lock:
            versions = set()
            for v in self.per_variant.values():
                versions |= set(v["weight_versions"])
            for tl in self.replica_versions.values():
                versions |= {wv for _, wv in tl}
            return {
                "replica_weight_versions": {
                    rid: [list(point) for point in tl]
                    for rid, tl in sorted(self.replica_versions.items())
                },
                "versions_observed": sorted(versions),
            }

    def phase_report(self):
        """JSON-ready per-phase split of the shaped run (p50/p95/p99 per
        schedule phase — where "TTFT during the burst" lives)."""
        with self.lock:
            return {
                name: {
                    "completed": b["completed"],
                    "shed": b["shed"],
                    "errored": b["errored"],
                    "tokens": b["tokens"],
                    "ttft_ms": {k: round(x * 1e3, 3) for k, x in
                                _percentiles(b["ttft_s"]).items()},
                    "latency_ms": {k: round(x * 1e3, 3) for k, x in
                                   _percentiles(b["latency_s"]).items()},
                }
                for name, b in self.per_phase.items()
            }

    def reject(self, reason, phase=None):
        with self.lock:
            self.shed += 1
            self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
            if phase is not None:
                self._phase_bucket(phase)["shed"] += 1

    def error(self, phase=None):
        with self.lock:
            self.errored += 1
            if phase is not None:
                self._phase_bucket(phase)["errored"] += 1

    def stream_abort(self, phase=None):
        with self.lock:
            self.stream_aborted += 1
            if phase is not None:
                self._phase_bucket(phase)["stream_aborted"] += 1

    def attribute(self, headers):
        """Record routing metadata from a response's headers (no-op for
        a bare replica, which sends neither header)."""
        if headers is None:
            return
        replica = headers.get("X-Replica")
        attempts = headers.get("X-Attempts")
        trail = headers.get("X-Attempt-Trail")
        wv = headers.get("X-Weight-Version")
        with self.lock:
            if replica:
                self.per_replica[replica] = (
                    self.per_replica.get(replica, 0) + 1)
                if wv is not None:
                    try:
                        wvi = int(wv)
                    except ValueError:
                        wvi = None
                    if wvi is not None:
                        tl = self.replica_versions.setdefault(replica, [])
                        if ((not tl or tl[-1][1] != wvi)
                                and len(tl) < 512):
                            tl.append([
                                round(time.monotonic() - self.t0, 3), wvi])
            if attempts:
                try:
                    self.failovers += max(0, int(attempts) - 1)
                except ValueError:
                    pass
            if trail and len(self.trails) < 256:
                self.trails.append(trail)


class _PhaseAcct:
    """View of an ``_Accounting`` that tags every outcome with the
    schedule phase the request was dispatched in. The submit paths see
    the same four-method surface; the global totals are untouched."""

    __slots__ = ("acct", "phase")

    def __init__(self, acct, phase):
        self.acct = acct
        self.phase = phase

    def complete(self, *args, **kwargs):
        self.acct.complete(*args, phase=self.phase, **kwargs)

    def reject(self, reason):
        self.acct.reject(reason, phase=self.phase)

    def error(self):
        self.acct.error(phase=self.phase)

    def stream_abort(self):
        self.acct.stream_abort(phase=self.phase)

    def attribute(self, headers):
        self.acct.attribute(headers)


# Traffic shapes: ordered (phase, rate-multiplier) pieces, each holding
# an EQUAL share of wall time at ``--rate x multiplier``. diurnal is the
# compressed day (trough → ramp → peak → evening → night) an autoscaler
# rides up and down; burst is the step-function spike that tests
# reaction time; step is the minimal two-level regime change.
SHAPES = {
    "diurnal": (("trough", 0.3), ("ramp", 0.8), ("peak", 1.6),
                ("evening", 0.8), ("night", 0.3)),
    "burst": (("baseline", 0.4), ("burst", 2.4), ("recovery", 0.4)),
    "step": (("low", 0.5), ("high", 1.5)),
}


def build_shape_plan(shape, num_requests, rate):
    """Piecewise open-loop arrival plan: ``[(offset_s, phase), ...]`` of
    exactly ``num_requests`` entries. Phases get equal wall duration;
    within a phase arrivals are evenly spaced at ``rate x multiplier``,
    so request counts are proportional to the multiplier. Deterministic
    — the same flags always produce the same schedule."""
    pieces = SHAPES[shape]
    total_mult = sum(m for _, m in pieces)
    # Phase duration such that the whole plan spends ~num_requests.
    dur = num_requests / (rate * total_mult)
    plan = []
    t0 = 0.0
    for idx, (phase, mult) in enumerate(pieces):
        r = rate * mult
        n = int(round(dur * r))
        if idx == len(pieces) - 1:
            n = num_requests - len(plan)  # absorb rounding drift
        for k in range(max(0, n)):
            plan.append((t0 + k / r, phase))
        t0 += dur
    return plan[:num_requests]


def _read_sse(resp, t0, acct):
    """Consume one SSE /generate response. Returns True when a terminal
    ``done`` frame arrived (the no-silent-drop criterion for streams);
    TTFT is the wall arrival of the FIRST token frame — the user-visible
    figure, not the replica's self-report."""
    event = None
    ttft = None
    tokens = 0
    done = None
    gaps = []
    last_frame = None
    try:
        for raw in resp:
            line = raw.decode("utf-8", "replace").rstrip("\n\r")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                obj = json.loads(line[len("data: "):])
                if event == "token":
                    now = time.monotonic()
                    if ttft is None:
                        ttft = now - t0
                    else:
                        # True client-side inter-token gap: successive token
                        # frame arrivals (what chunked prefill must protect).
                        gaps.append(now - last_frame)
                    last_frame = now
                    tokens += len(obj.get("tokens", ()))
                elif event == "done":
                    done = obj
    except Exception:  # noqa: BLE001 — a dirty cut is still a truncation
        # Transport died mid-stream (RST, timeout, garbage frame): same
        # classification as a clean truncation — the token count decides
        # stream_aborted vs dropped below.
        done = None
    if done is None:
        if tokens > 0:
            # Truncated AFTER tokens flowed: the typed partial-stream
            # outcome (the router never retries a committed stream; the
            # truncation IS the failure signal) — visible, accounted,
            # not a silent drop.
            acct.stream_abort()
        else:
            # Nothing arrived at all: a drop, not a shed.
            acct.error()
        return False
    if "error" in done:
        acct.reject(done["error"])
        return True
    acct.complete(
        ttft if ttft is not None else time.monotonic() - t0,
        time.monotonic() - t0,
        tokens or len(done.get("tokens", ())),
        gaps=gaps,
        variant=done.get("variant", ""),
        weight_version=done.get("weight_version"),
    )
    return True


def _http_submit(url, payload, timeout_s, acct, stream=False):
    import urllib.error
    import urllib.request

    t0 = time.monotonic()
    if stream:
        payload = {**payload, "stream": True}
    req = urllib.request.Request(
        url + "/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            acct.attribute(resp.headers)
            ctype = resp.headers.get("Content-Type", "")
            if ctype.startswith("text/event-stream"):
                _read_sse(resp, t0, acct)
                return
            variant = resp.headers.get("X-Variant")
            wv = resp.headers.get("X-Weight-Version")
            body = json.loads(resp.read())
        acct.complete(
            body.get("ttft_ms", 0.0) / 1e3,
            time.monotonic() - t0,
            len(body.get("tokens", ())),
            variant=variant if variant is not None
            else body.get("variant", ""),
            weight_version=wv if wv is not None
            else body.get("weight_version"),
        )
    except urllib.error.HTTPError as e:
        try:
            reason = json.loads(e.read()).get("error", f"http_{e.code}")
        except Exception:
            reason = f"http_{e.code}"
        # A structured 4xx/5xx IS the shed response — typed, not dropped.
        acct.attribute(e.headers)
        acct.reject(reason)
    except Exception:
        acct.error()


def _sched_submit(scheduler, payload, timeout_s, acct):
    from distributed_tensorflow_tpu_torch.serve.scheduler import Completion, Request

    pending = scheduler.submit(Request(
        prompt=tuple(payload["prompt"]),
        max_new_tokens=payload["max_new_tokens"],
        temperature=payload.get("temperature", 0.0),
        top_k=payload.get("top_k", 0),
        top_p=payload.get("top_p", 0.0),
        seed=payload.get("seed", 0),
        deadline_s=payload.get("deadline_s"),
    ))
    try:
        outcome = pending.result(timeout=timeout_s)
    except TimeoutError:
        acct.error()
        return
    if isinstance(outcome, Completion):
        acct.complete(outcome.ttft_s, outcome.latency_s, len(outcome.tokens),
                      variant=outcome.variant,
                      weight_version=outcome.weight_version)
    else:
        acct.reject(outcome.reason)


def _scrape_health(url, server):
    """(slo_status_dict | None, recompile_events_total | None,
    fastpath_rates dict) from a live target: HTTP mode scrapes
    ``/slo.json`` + ``/metrics`` (Prometheus text); self-serve mode reads
    the in-process monitor/sentinel/metrics that ``serve_lm.build_stack``
    hung on the server object. The fastpath dict carries the decode
    fast-path gauges (``serve_prefix_hit_rate`` /
    ``serve_spec_accept_rate``) so prefix-cache and speculation
    effectiveness are visible end to end — including through the fleet
    router. Never raises — a server without the endpoints just yields
    nulls."""
    fastpath = {"prefix_hit_rate": None, "spec_accept_rate": None,
                "spec_accept_rate_by_drafter": {},
                "weight_dtype": None, "weight_bytes_per_device": None,
                "kv_dtype": None, "kv_bytes_per_token": None,
                "spec_accept_per_verify": None,
                "spec_accepted_per_verify_p50": None,
                "spec_accepted_per_verify_p99": None}
    if url:
        import urllib.request

        base = url.rstrip("/")
        slo = recompiles = None
        try:
            with urllib.request.urlopen(base + "/slo.json", timeout=5) as r:
                slo = json.loads(r.read())
        except Exception:
            pass
        try:
            with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
                text = r.read().decode()
            from distributed_tensorflow_tpu_torch.obs.export import parse_prometheus_text
            from distributed_tensorflow_tpu_torch.serve import metric_names as mn

            for sample in parse_prometheus_text(text):
                if sample["name"] == mn.RECOMPILE_EVENTS_TOTAL:
                    recompiles = int(sample["value"])
                elif sample["name"] == mn.SERVE_PREFIX_HIT_RATE:
                    fastpath["prefix_hit_rate"] = float(sample["value"])
                elif sample["name"] == mn.SERVE_SPEC_ACCEPT_RATE:
                    fastpath["spec_accept_rate"] = float(sample["value"])
                elif sample["name"] == mn.SERVE_SPEC_ACCEPT_RATE_BY_DRAFTER:
                    drafter = sample.get("labels", {}).get("drafter", "?")
                    fastpath["spec_accept_rate_by_drafter"][drafter] = float(
                        sample["value"])
                elif sample["name"] == mn.SERVE_WEIGHT_BYTES_PER_DEVICE:
                    fastpath["weight_bytes_per_device"] = int(sample["value"])
                elif sample["name"] == mn.SERVE_KV_BYTES_PER_TOKEN:
                    fastpath["kv_bytes_per_token"] = float(sample["value"])
                elif sample["name"] == mn.SERVE_SPEC_ACCEPT_PER_VERIFY:
                    fastpath["spec_accept_per_verify"] = float(sample["value"])
                elif sample["name"] == mn.SERVE_SPEC_ACCEPTED_PER_VERIFY_P50:
                    fastpath["spec_accepted_per_verify_p50"] = float(
                        sample["value"])
                elif sample["name"] == mn.SERVE_SPEC_ACCEPTED_PER_VERIFY_P99:
                    fastpath["spec_accepted_per_verify_p99"] = float(
                        sample["value"])
        except Exception:
            pass
        # Quant mode rides /healthz (it is a string — no Prometheus home).
        try:
            import urllib.error
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                    body = json.loads(r.read())
            except urllib.error.HTTPError as err:  # 503 is still an answer
                body = json.loads(err.read())
            fastpath["weight_dtype"] = body.get("weight_dtype")
            fastpath["kv_dtype"] = body.get("kv_dtype")
        except Exception:
            pass
        return slo, recompiles, fastpath
    if server is None:
        return None, None, fastpath
    slo = None
    monitor = getattr(server, "slo_monitor", None)
    if monitor is not None:
        slo = monitor.evaluate()  # fresh read — no ticker in loadgen
        slo["enabled"] = True
    sentinel = getattr(server, "sentinel", None)
    recompiles = sentinel.post_warm_total if sentinel is not None else None
    metrics = getattr(server, "serving_metrics", None)
    if metrics is not None:
        fastpath["prefix_hit_rate"] = float(metrics.prefix_hit_rate)
        fastpath["spec_accept_rate"] = float(metrics.spec_accept_rate)
        snap = metrics.snapshot()
        fastpath["spec_accept_rate_by_drafter"] = (
            snap.get("spec_accept_rate_by_drafter", {}))
        fastpath["weight_dtype"] = snap.get("weight_dtype")
        wb = snap.get("weight_bytes_per_device")
        fastpath["weight_bytes_per_device"] = int(wb) if wb else None
        fastpath["kv_dtype"] = snap.get("kv_dtype") or None
        kb = snap.get("kv_bytes_per_token")
        fastpath["kv_bytes_per_token"] = float(kb) if kb else None
        for key in ("spec_accept_per_verify",
                    "spec_accepted_per_verify_p50",
                    "spec_accepted_per_verify_p99"):
            val = snap.get(key)
            fastpath[key] = float(val) if val is not None else None
    return slo, recompiles, fastpath


def _scrape_handoff(urls):
    """The KV-page handoff funnel of prefill replicas: not ported yet (the
    port serves no handoff roles)."""
    raise NotImplementedError(f"the handoff funnel scrape (--handoff_report) {_NOT_PORTED}")


def _scrape_rollout(url):
    """Fleet rollout counters of a router: not ported yet (the port runs no
    fleet). Returns ``(totals_by_outcome, replicas_current)`` empty."""
    return {}, None


def run_load(
    submit_one,
    *,
    num_requests,
    concurrency,
    rate,
    make_payload,
    timeout_s,
    mid_run_hook=None,
    schedule=None,
):
    """Drive ``submit_one(payload)`` for ``num_requests`` requests.
    ``rate`` > 0 switches to open loop at that many req/s.
    ``schedule`` — a ``[(offset_s, phase), ...]`` plan from
    :func:`build_shape_plan` — supersedes the flat rate: arrivals follow
    the plan's offsets and every outcome is additionally tagged with its
    phase (``acct.per_phase``).
    ``mid_run_hook`` fires exactly once, just before the request at the
    halfway index is dispatched — the swap-under-load lever: the e2e
    test and ``bench_hotswap`` publish a new checkpoint from it, so
    roughly half the burst lands on each weight version."""
    acct = _Accounting()
    threads = []
    hook_lock = threading.Lock()
    hook_done = [mid_run_hook is None]

    def maybe_hook(i):
        if i < num_requests // 2 or hook_done[0]:
            return
        with hook_lock:
            if hook_done[0]:
                return
            hook_done[0] = True
        mid_run_hook()

    t_start = time.monotonic()
    if schedule:
        # Shaped open loop: piecewise arrival plan, phase-tagged
        # accounting. Late completions never delay the next arrival.
        for i, (offset, phase) in enumerate(schedule):
            target = t_start + offset
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            maybe_hook(i)
            th = threading.Thread(
                target=submit_one,
                args=(make_payload(i), timeout_s, _PhaseAcct(acct, phase)),
                daemon=True,
            )
            th.start()
            threads.append(th)
    elif rate and rate > 0:
        # Open loop: fixed schedule, one thread per in-flight request; late
        # completions never delay the next arrival.
        for i in range(num_requests):
            target = t_start + i / rate
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            maybe_hook(i)
            th = threading.Thread(
                target=submit_one, args=(make_payload(i), timeout_s, acct),
                daemon=True,
            )
            th.start()
            threads.append(th)
    else:
        idx_lock = threading.Lock()
        next_idx = [0]

        def worker():
            while True:
                with idx_lock:
                    i = next_idx[0]
                    if i >= num_requests:
                        return
                    next_idx[0] += 1
                maybe_hook(i)
                submit_one(make_payload(i), timeout_s, acct)

        for _ in range(max(1, concurrency)):
            th = threading.Thread(target=worker, daemon=True)
            th.start()
            threads.append(th)
    for th in threads:
        th.join(timeout_s + 30.0)
    wall_s = time.monotonic() - t_start
    return acct, wall_s


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--url", default="",
        help="serve_lm endpoint; empty = self-serve demo weights in-process",
    )
    parser.add_argument(
        "--targets", default="",
        help="comma-separated endpoints — one fleet-router URL, or several "
        "replica URLs to spray round-robin (supersedes --url when set)",
    )
    parser.add_argument(
        "--stream", action="store_true",
        help="HTTP mode: request SSE streams and measure TTFT at the "
        "client (wall arrival of the first token frame)",
    )
    parser.add_argument("--num_requests", type=int, default=32)
    parser.add_argument(
        "--concurrency", type=int, default=8,
        help="closed-loop worker count (ignored with --rate)",
    )
    parser.add_argument(
        "--rate", type=float, default=0.0,
        help="open-loop arrival rate in req/s (0 = closed loop)",
    )
    parser.add_argument(
        "--shape", default="", choices=["", *sorted(SHAPES)],
        help="open-loop traffic shape: piecewise rate schedule "
        "(equal-duration phases at --rate x per-phase multiplier) with "
        "per-phase p50/p95/p99 in the report; requires --rate",
    )
    parser.add_argument("--prompt_len", type=int, default=8)
    parser.add_argument("--max_new_tokens", type=int, default=16)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument(
        "--deadline_s", type=float, default=0.0,
        help="per-request queue-wait deadline (0 = none)",
    )
    parser.add_argument(
        "--deadline_ms", type=float, default=0.0,
        help="per-request end-to-end deadline in milliseconds (0 = none; "
        "supersedes --deadline_s) — through a fleet router this becomes "
        "the propagated X-Budget-Ms budget",
    )
    parser.add_argument("--timeout_s", type=float, default=60.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--smoke", action="store_true",
        help="CI gate: exit nonzero if any request was dropped without a "
        "typed shed response, or nothing completed",
    )
    parser.add_argument(
        "--report_file", default="LOADGEN_LAST.jsonl",
        help="append the machine-parseable report record here as one JSONL "
             "line (bench.py's BENCH_LAST.json convention — appended, so "
             "serving-latency trends accumulate across runs; '' disables)",
    )
    parser.add_argument(
        "--handoff_report", default="",
        help="comma-separated base URLs of prefill-tier replicas to "
        "scrape (/metrics.json) for the KV-page handoff funnel: outcome "
        "counts, wire bytes, per-chunk encode percentiles, per-peer "
        "throughput EWMA and tier stall. With --smoke the run FAILS if "
        "any handoff fell back SILENTLY (exports not accounted for by "
        "an accepted or typed-fallback outcome)",
    )
    parser.add_argument(
        "--long_prompts", action="store_true",
        help="mix in prompts LONGER than the prefill window (up to "
        "seq_len - max_new - 1): the chunked-prefill workload — half the "
        "requests draw long, half stay short/heterogeneous",
    )
    parser.add_argument(
        "--swap_mid_run", default="",
        help="shell command to run once at the halfway request index — "
        "e.g. a script that publishes a committed checkpoint into the "
        "target's --watch_dir, turning the run into a swap-under-load "
        "measurement (per-variant / per-weight-version attribution in "
        "the report shows the before/after split)",
    )
    parser.add_argument(
        "--prefix_groups", type=int, default=0,
        help="shared-prefix workload: N groups of requests, each group "
        "sharing a long common prompt prefix (~3/4 of prompt_len) with "
        "per-request random tails — the traffic shape the prefix cache "
        "serves; 0 = fully random prompts",
    )
    # Self-serve engine shape (ignored with --url).
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--seq_len", type=int, default=64)
    parser.add_argument("--steps_per_sync", type=int, default=1)
    parser.add_argument(
        "--page_size", type=int, default=-1,
        help="self-serve KV page size (-1 auto, 0 monolithic)",
    )
    parser.add_argument(
        "--spec_k", type=int, default=4,
        help="self-serve speculative drafts per verify round (0 = off)",
    )
    parser.add_argument(
        "--spec_branches", type=int, default=1,
        help="self-serve draft-tree branches per slot (>1 turns on the "
        "cross-slot shared draft tree; 1 = linear drafts)",
    )
    parser.add_argument(
        "--kv_dtype", default="", choices=("", "bf16", "int8"),
        help="self-serve KV activation format: 'int8' = quantize-on-write "
        "paged KV (the byte diet); '' keeps the model's native setting",
    )
    parser.add_argument(
        "--tp", type=int, default=1,
        help="self-serve tensor-parallel width (1 only: the sharded engine "
        "is not ported yet)",
    )
    parser.add_argument(
        "--model", default="",
        help="self-serve this bundle (either package's; quantized ones "
        "too) instead of the demo weights",
    )
    parser.add_argument("--device", default="cuda", help="self-serve on cuda (default) or cpu")
    args, _ = parser.parse_known_args(argv)
    if args.tp != 1:
        parser.error(f"--tp {args.tp}: the sharded engine (ShardedSlotEngine) {_NOT_PORTED}")
    if args.handoff_report:
        parser.error(f"--handoff_report: the handoff funnel scrape {_NOT_PORTED}")

    if args.shape and not args.rate > 0:
        parser.error("--shape needs an open loop: pass --rate R")
    schedule = (build_shape_plan(args.shape, args.num_requests, args.rate)
                if args.shape else None)

    import random

    rng = random.Random(args.seed)

    deadline_s = args.deadline_s
    if args.deadline_ms > 0:
        deadline_s = args.deadline_ms / 1e3

    group_prefixes = []
    if args.prefix_groups > 0:
        # The shared prefix must span whole KV pages to be adoptable, so
        # make it the bulk of the prompt; tails stay heterogeneous.
        plen = max(1, (args.prompt_len * 3) // 4)
        group_prefixes = [
            [rng.randint(0, 255) for _ in range(plen)]
            for _ in range(args.prefix_groups)
        ]

    def make_payload(i):
        # Heterogeneous prompt/output lengths: the serving engine's whole
        # point is that this mix shares one compiled program.
        n = rng.randint(1, max(1, args.max_new_tokens))
        if args.long_prompts and i % 2 == 1:
            # Beyond the prefill window (self-serve sizes it at
            # max(prompt_len, seq_len // 2)) but within the engine cap
            # p + n <= seq_len: the chunked-prefill path end to end.
            lo = max(args.prompt_len, args.seq_len // 2) + 1
            hi = args.seq_len - n - 1
            if hi < lo:
                n = max(1, args.seq_len - lo - 1)
                hi = lo
            p = rng.randint(lo, hi)
            return {
                "prompt": [rng.randint(0, 255) for _ in range(p)],
                "max_new_tokens": n,
                "temperature": args.temperature,
                "seed": i,
                **({"deadline_s": deadline_s} if deadline_s > 0 else {}),
            }
        if group_prefixes:
            prefix = group_prefixes[i % len(group_prefixes)]
            tail_max = max(1, args.prompt_len - len(prefix))
            tail = [rng.randint(0, 255)
                    for _ in range(rng.randint(1, tail_max))]
            prompt = prefix + tail
        else:
            p = rng.randint(1, max(1, args.prompt_len))
            prompt = [rng.randint(0, 255) for _ in range(p)]
        payload = {
            "prompt": prompt,
            "max_new_tokens": n,
            "temperature": args.temperature,
            "seed": i,
        }
        if deadline_s > 0:
            payload["deadline_s"] = deadline_s
        return payload

    targets = [t.rstrip("/") for t in args.targets.split(",") if t.strip()]
    if not targets and args.url:
        targets = [args.url.rstrip("/")]

    scheduler = None
    server = None
    if targets:
        def submit_one(payload, timeout_s, acct):
            # Deterministic round-robin over targets; with one router URL
            # this degenerates to "always the router", which then does the
            # real (health-aware) balancing.
            target = targets[payload.get("seed", 0) % len(targets)]
            _http_submit(target, payload, timeout_s, acct,
                         stream=args.stream)
    else:
        from distributed_tensorflow_tpu_torch.cli.serve_lm import build_stack
        from distributed_tensorflow_tpu_torch.config import ServeConfig
        from distributed_tensorflow_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )
        from distributed_tensorflow_tpu_torch.utils.device import compute_dtype, resolve_device

        device = resolve_device(args.device)
        if args.model:
            from distributed_tensorflow_tpu_torch.train.checkpoint import load_lm_bundle

            cfg, model, _ = load_lm_bundle(args.model, device=device)
        else:
            cfg = TransformerConfig(
                vocab_size=256, d_model=64, num_heads=4, num_layers=2, d_ff=128,
                max_seq_len=args.seq_len, compute_dtype=compute_dtype(device),
            )
            model = TransformerLM(cfg, seed=0, device=device)
        serve_cfg = ServeConfig(
            slots=args.slots,
            serve_max_len=args.seq_len,
            prefill_len=max(args.prompt_len, args.seq_len // 2),
            steps_per_sync=args.steps_per_sync,
            page_size=args.page_size,
            spec_k=args.spec_k,
            spec_branches=args.spec_branches,
            kv_dtype=args.kv_dtype,
        )
        engine, scheduler, metrics, server = build_stack(serve_cfg, cfg, model)
        server.server_close()  # wiring only — loadgen submits directly
        scheduler.start()

        def submit_one(payload, timeout_s, acct):
            _sched_submit(scheduler, payload, timeout_s, acct)

    mid_run_hook = None
    if args.swap_mid_run:
        import subprocess

        def mid_run_hook():
            print(f"swap_mid_run: {args.swap_mid_run}", file=sys.stderr)
            subprocess.run(args.swap_mid_run, shell=True, check=False)

    acct, wall_s = run_load(
        submit_one,
        num_requests=args.num_requests,
        concurrency=args.concurrency,
        rate=args.rate,
        make_payload=make_payload,
        timeout_s=args.timeout_s,
        mid_run_hook=mid_run_hook,
        schedule=schedule,
    )
    # Scrape server health BEFORE teardown so the report record is
    # self-describing: was the server SLO-degraded during this run, and did
    # the engine recompile after warmup (it must not)?
    slo_status, recompiles, fastpath = _scrape_health(
        targets[0] if targets else "", server)
    # Rollout view: the per-replica weight-version timelines this run's
    # responses traced out + the controller's fleet counters (scraped
    # off the first target, which is the router in fleet runs).
    rollout_totals, rollout_current = _scrape_rollout(
        targets[0] if targets else "")
    rollout_section = acct.rollout_report()
    rollout_section["fleet_rollout_total"] = rollout_totals
    rollout_section["fleet_rollout_replicas_current"] = rollout_current
    rollout_section["fleet_scrape"] = f"the fleet rollout scrape {_NOT_PORTED}"
    handoff_report = None
    if args.handoff_report:
        handoff_report = _scrape_handoff(
            [u.strip() for u in args.handoff_report.split(",")
             if u.strip()])
    # Serving-mesh topology for the report: self-serve reads the engine,
    # HTTP mode scrapes /healthz (best-effort — older servers lack it).
    mesh_info = None
    if scheduler is not None:
        eng = scheduler.engine
        mesh_info = {"tp": int(getattr(eng, "tp", 1)),
                     "devices": int(getattr(eng, "mesh_device_count", 1))}
    elif targets:
        import urllib.error
        import urllib.request
        try:
            try:
                with urllib.request.urlopen(
                        targets[0].rstrip("/") + "/healthz", timeout=5) as r:
                    mesh_info = json.loads(r.read()).get("mesh")
            except urllib.error.HTTPError as err:  # 503 is still an answer
                mesh_info = json.loads(err.read()).get("mesh")
        except Exception:  # noqa: BLE001 — report stays best-effort
            pass
    if scheduler is not None:
        scheduler.stop()

    accounted = (acct.completed + acct.shed + acct.errored
                 + acct.stream_aborted)
    # Typed outcome classes: every request lands in exactly one. A shed
    # splits by reason — "deadline" (budget expired before service),
    # failover exhaustion (the router ran out of upstreams), and capacity
    # sheds (the scheduler/server refused admission) are distinct operator
    # signals. Together with "deadline" these sets must claim every
    # Rejection kind and router error tag (dttlint rejection-kinds).
    _exhausted_reasons = {"upstream_unreachable", "upstream_died",
                          "no_upstream"}
    _capacity_shed_reasons = {"queue_full", "shutting_down",
                              "insufficient_pages", "invalid", "not_found"}
    failover_exhausted = sum(
        v for k, v in acct.shed_reasons.items() if k in _exhausted_reasons)
    capacity_shed = sum(
        v for k, v in acct.shed_reasons.items() if k in _capacity_shed_reasons)
    deadline_shed = acct.shed_reasons.get("deadline", 0)
    report = {
        "num_requests": args.num_requests,
        "completed": acct.completed,
        "shed": acct.shed,
        "shed_reasons": acct.shed_reasons,
        "stream_aborted": acct.stream_aborted,
        "outcomes": {
            "ok": acct.completed,
            "deadline": deadline_shed,
            "failover_exhausted": failover_exhausted,
            "capacity_shed": capacity_shed,
            "shed_unknown": (acct.shed - deadline_shed
                             - failover_exhausted - capacity_shed),
            "stream_aborted": acct.stream_aborted,
            "errored": acct.errored,
        },
        "attempt_trails": acct.trails[:64],
        "dropped_without_shed": acct.errored + (args.num_requests - accounted),
        "wall_s": round(wall_s, 4),
        "throughput_tok_s": round(acct.tokens / wall_s, 2) if wall_s > 0 else 0.0,
        "ttft_ms": {
            k: round(v * 1e3, 3) for k, v in _percentiles(acct.ttft_s).items()
        },
        "latency_ms": {
            k: round(v * 1e3, 3)
            for k, v in _percentiles(acct.latency_s).items()
        },
        "intertoken_ms": {
            k: round(v * 1e3, 3)
            for k, v in _percentiles(acct.intertoken_s).items()
        },
        "mode": "open" if args.rate > 0 else "closed",
        "shape": args.shape,
        "per_phase": acct.phase_report(),
        "mesh": mesh_info,
        "slo": slo_status,
        "recompile_events_total": recompiles,
        "prefix_groups": args.prefix_groups,
        "long_prompts": bool(args.long_prompts),
        "serve_prefix_hit_rate": fastpath["prefix_hit_rate"],
        "serve_spec_accept_rate": fastpath["spec_accept_rate"],
        "serve_spec_accept_rate_by_drafter":
            fastpath["spec_accept_rate_by_drafter"],
        "weight_dtype": fastpath["weight_dtype"],
        "serve_weight_bytes_per_device": fastpath["weight_bytes_per_device"],
        "kv_dtype": fastpath["kv_dtype"],
        "serve_kv_bytes_per_token": fastpath["kv_bytes_per_token"],
        "serve_spec_accept_per_verify": fastpath["spec_accept_per_verify"],
        "serve_spec_accepted_per_verify_p50":
            fastpath["spec_accepted_per_verify_p50"],
        "serve_spec_accepted_per_verify_p99":
            fastpath["spec_accepted_per_verify_p99"],
        "t_wall": time.time(),
        "concurrency": args.concurrency,
        "rate": args.rate,
        "slots": args.slots,
        "url": args.url,
        "targets": targets,
        "stream": bool(args.stream),
        "per_replica": acct.per_replica,
        "failovers": acct.failovers,
        "per_variant": acct.variant_report(),
        "swap_mid_run": args.swap_mid_run,
        "handoff": handoff_report,
        "rollout": rollout_section,
    }
    print(json.dumps(report))
    if args.report_file:
        with open(args.report_file, "a") as f:
            f.write(json.dumps(report) + "\n")
    if args.smoke:
        if report["dropped_without_shed"] > 0:
            print(
                f"SMOKE FAIL: {report['dropped_without_shed']} request(s) "
                "dropped without a typed shed response",
                file=sys.stderr,
            )
            return 1
        if acct.completed == 0:
            print("SMOKE FAIL: no request completed", file=sys.stderr)
            return 1
        if handoff_report is not None:
            silent = handoff_report["totals"]["silent_fallbacks"]
            if silent > 0:
                print(
                    f"SMOKE FAIL: {silent} handoff export(s) never "
                    "reached an accepted or typed-fallback outcome "
                    "(silent fallback)",
                    file=sys.stderr,
                )
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
