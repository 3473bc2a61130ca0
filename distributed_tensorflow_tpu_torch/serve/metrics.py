"""Serving observability: latency histograms + queue/occupancy gauges.

This package's copy of ``distributed_tensorflow_tpu/serve/metrics.py``; its
:meth:`ServingMetrics.publish` writes scalars only, as this package's
``utils/summary.py`` does.

Built on the unified :mod:`distributed_tensorflow_tpu_torch.obs` registry — every
instrument here is a registered family in a PRIVATE
:class:`~distributed_tensorflow_tpu_torch.obs.registry.MetricsRegistry` (exposed as
``.registry``), which is what ``serve/server.py`` renders at ``GET /metrics``
in Prometheus text form. A private registry (rather than the process default)
keeps concurrently-constructed serving stacks — and tests — isolated from
each other and from the train-side metrics.

The obs ``Histogram`` (re-exported here for compatibility) locks both its
writes and its read snapshots, which fixes the old crash: the reservoir used
to be a bare deque that ``ThreadingHTTPServer`` handler threads iterated via
``np.percentile`` while the scheduler thread appended — a concurrent-append
``RuntimeError: deque mutated during iteration`` under scrape load.

The two latencies that matter, measured where the SLO is felt:

* **TTFT** (time to first token) — submit → first sampled token; includes
  queue wait + prefill, so admission-control failures show up here first.
* **per-token latency** — the inter-token gap on the decode path; under
  continuous batching this is one engine round divided by the tokens it
  produced, the number the 2x-vs-sequential bench ratchet guards.
"""

from __future__ import annotations

import threading

from distributed_tensorflow_tpu_torch.obs.registry import (  # noqa: F401  (re-export)
    Histogram,
    MetricsRegistry,
)

__all__ = ["Histogram", "ServingMetrics"]

# Latency ladder for TTFT / per-token: 1 ms – 10 s (the registry default).
# Queue depth and occupancy get their own scales below.
_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
_FRAC_BUCKETS = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 1.0)


class ServingMetrics:
    """One serving process's counters, gauges, and latency histograms.

    Thread-safe (the HTTP server's handler threads observe TTFT while the
    scheduler thread observes round latencies) — each instrument carries its
    own lock. Units are seconds internally; ``snapshot()`` reports
    milliseconds for the latency fields because that is the scale humans
    read SLOs in.
    """

    def __init__(self, histogram_maxlen: int = 4096):
        self.registry = MetricsRegistry()
        r = self.registry
        n = histogram_maxlen
        self.ttft = r.histogram(
            "serve_ttft_seconds",
            "Time to first token: submit -> first sampled token.", maxlen=n)
        self.per_token = r.histogram(
            "serve_per_token_seconds",
            "Inter-token gap: engine round time / tokens produced.", maxlen=n)
        self.queue_depth = r.histogram(
            "serve_queue_depth",
            "Admission queue depth observed at submit.",
            maxlen=n, buckets=_DEPTH_BUCKETS)
        self.occupancy = r.histogram(
            "serve_slot_occupancy",
            "Fraction of engine slots busy, observed each round.",
            maxlen=n, buckets=_FRAC_BUCKETS)
        self._completed = r.counter(
            "serve_completed_total", "Requests finished with a result.")
        self._shed = r.counter(
            "serve_shed_total", "Requests rejected or dropped.")
        self._tokens_out = r.counter(
            "serve_tokens_out_total", "Valid tokens produced.")
        self._queue_depth_gauge = r.gauge(
            "serve_queue_depth_current", "Admission queue depth, last seen.")
        self._queue_depth_peak = r.gauge(
            "serve_queue_depth_peak", "Max queue depth seen this process.")
        # Point-in-time gauges the fleet router scrapes for least-loaded
        # dispatch (histograms summarize history; dispatch needs "now").
        self._occupancy_gauge = r.gauge(
            "serve_slot_occupancy_current",
            "Fraction of engine slots busy, last observed round.")
        self._lane_depth = r.gauge(
            "serve_lane_depth_current",
            "Queued requests per priority lane, last seen at submit.",
            labels=("lane",))
        # Decode fast-path instruments (paged KV / prefix cache /
        # speculative decoding). Counters carry the raw totals; the rate
        # gauges are derived at sync time so scrapers (fleet router,
        # loadgen reports, bench gates) read a ready 0..1 value.
        self._prefix_matched = r.counter(
            "serve_prefix_tokens_matched_total",
            "Prompt tokens whose KV was adopted from the prefix cache.")
        self._prefix_total = r.counter(
            "serve_prefix_tokens_total",
            "Prompt tokens offered to prefix-cache lookup.")
        # Labeled by drafter ("ngram" | "model") so a fleet can compare
        # acceptance between the zero-weight fallback and the learned
        # draft head from one scrape, and by the weight dtypes of the
        # target / drafter models so a mixed-precision fleet (int4
        # drafter over int8 target next to bf16 replicas) can slice
        # acceptance by quantization pairing.
        self._spec_accepted = r.counter(
            "serve_spec_drafts_accepted_total",
            "Drafted tokens accepted by the speculative verify step.",
            labels=("drafter", "target_dtype", "draft_dtype"))
        self._spec_proposed = r.counter(
            "serve_spec_drafts_proposed_total",
            "Drafted tokens proposed to the speculative verify step.",
            labels=("drafter", "target_dtype", "draft_dtype"))
        self._prefill_chunks = r.counter(
            "serve_prefill_chunks_total",
            "Prefill chunks executed (chunked-prefill path only).")
        self._prefix_hit_rate = r.gauge(
            "serve_prefix_hit_rate",
            "Cumulative fraction of prompt tokens served from the prefix "
            "cache (adopted pages / prompt tokens).")
        self._spec_accept_rate = r.gauge(
            "serve_spec_accept_rate",
            "Cumulative fraction of speculative drafts accepted.")
        self._spec_accept_rate_by = r.gauge(
            "serve_spec_accept_rate_by_drafter",
            "Cumulative speculative accept fraction, per drafter.",
            labels=("drafter",))
        self._prefill_budget = r.gauge(
            "serve_prefill_tokens_budget",
            "Per-iteration prefill token budget (chunk width; -1 = "
            "chunking off).")
        self._prefill_last_iter = r.gauge(
            "serve_prefill_tokens_last_iter",
            "Prefill tokens actually spent in the engine's last step.")
        self._pages_free = r.gauge(
            "serve_kv_pages_free_current",
            "Free physical KV pages (paged layout; 0 when monolithic).")
        self._page_occupancy = r.gauge(
            "serve_kv_page_occupancy_current",
            "Fraction of allocatable KV pages in use (paged layout).")
        self._hbm_per_slot = r.gauge(
            "serve_hbm_bytes_per_slot",
            "KV pool device bytes divided by slot count.")
        self._mesh_tp = r.gauge(
            "serve_mesh_tp",
            "Tensor-parallel width of the serving mesh (1 = replicated "
            "single-device engine).")
        self._hbm_per_device = r.gauge(
            "serve_hbm_bytes_per_device",
            "KV pool bytes RESIDENT per device (kv-head axis sharded "
            "tp ways; equals the pool size when tp=1).")
        self._weight_bytes_per_device = r.gauge(
            "serve_weight_bytes_per_device",
            "Target-model weight bytes RESIDENT per device (sharded "
            "leaves count their per-device shard). The quantization "
            "win shows here: int8 trees land near 0.5x of bf16, int4 "
            "near 0.3x at serving shapes.")
        # KV byte-diet instruments (PR 14): the pool's storage cost per
        # cacheable token position, and which activation format backs it.
        # ``serve_kv_dtype`` is an info-style gauge (value 1 on the live
        # label) because gauges hold floats; the plain string also rides
        # the snapshot next to weight_dtype.
        self._kv_bytes_per_token = r.gauge(
            "serve_kv_bytes_per_token",
            "KV pool device bytes per cacheable token position. At "
            "kv_dtype=int8 this is the byte-diet number: int8 rows + "
            "f32 per-row scales land well under bf16 storage.")
        self._kv_dtype_info = r.gauge(
            "serve_kv_dtype",
            "Live KV activation format (1 on the active dtype label).",
            labels=("dtype",))
        # Tree/linear speculation efficiency: accepted tokens per verify
        # call. The mean is the bench-gated number; p50/p99 come from the
        # engine's per-round accept reservoir for the loadgen report.
        self._spec_accept_per_verify = r.gauge(
            "serve_spec_accept_per_verify",
            "Cumulative drafted tokens accepted per speculative verify "
            "call (tree spec raises this over the linear drafter).")
        self._spec_apv_p50 = r.gauge(
            "serve_spec_accepted_per_verify_p50",
            "Median per-slot accepted tokens in one verify round.")
        self._spec_apv_p99 = r.gauge(
            "serve_spec_accepted_per_verify_p99",
            "p99 per-slot accepted tokens in one verify round.")
        # Deploy instruments (PR 12): which checkpoint step is live,
        # traffic attribution per weight variant, and swap outcomes —
        # the three numbers a rollout dashboard needs.
        self._weight_version = r.gauge(
            "serve_weight_version",
            "Checkpoint step of the live weights (0 = boot bundle, "
            "never hot-swapped).")
        self._variant_requests = r.counter(
            "serve_variant_requests_total",
            "Completed requests per weight variant (label '' = "
            "single-variant serving).",
            labels=("variant",))
        self._swap_total = r.counter(
            "serve_swap_total",
            "Weight hot-swap attempts by outcome (ok | rollback).",
            labels=("outcome",))
        # Disaggregated-tier handoff outcomes (PR 13). One counter family
        # covers both sides: the prefill tier emits export / accepted /
        # fallback / done / failed, the decode tier import /
        # import_rejected — a fleet-wide scrape shows the full funnel.
        self._handoff = r.counter(
            "serve_handoff_total",
            "KV-page handoff events between serving tiers, by outcome.",
            labels=("outcome",))
        self._handoff_outcomes: set = set()
        # Handoff fast-path instruments (PR 17). Bytes-on-wire split by
        # whether any chunk shipped zlib-compressed; per-chunk encode
        # latency; a per-peer EWMA of observed transfer throughput (the
        # outbox's own pushes feed it — the same number its peer score
        # consumes); and the driver-thread stall each side pays per
        # handoff event (export capture / import scatter), as both a
        # cumulative total and a worst-single-event gauge so the bench
        # can gate v2's bounded per-chunk stall against v1's whole-slot
        # block.
        self._handoff_bytes = r.counter(
            "fleet_handoff_bytes_total",
            "Handoff bytes on the wire, by compression.",
            labels=("compressed",))
        self._handoff_chunk_ms = r.histogram(
            "fleet_handoff_chunk_ms",
            "Per-chunk encode time of streamed handoff bundles (ms).",
            maxlen=n)
        self._handoff_tp = r.gauge(
            "fleet_handoff_throughput_bytes_per_s",
            "EWMA of observed handoff transfer throughput, per peer.",
            labels=("peer",))
        self._handoff_peers: set = set()
        self._handoff_stall_total = r.counter(
            "serve_handoff_stall_seconds_total",
            "Cumulative driver-thread block spent on handoff transfers, "
            "by side (export | import | commit).",
            labels=("side",))
        self._handoff_stall_max = r.gauge(
            "serve_handoff_stall_max_seconds",
            "Worst single driver-thread block of one handoff event, "
            "by side (export | import | commit).",
            labels=("side",))
        self._handoff_stall_counts = r.counter(
            "serve_handoff_stall_events_total",
            "Handoff driver-stall events recorded, by side.",
            labels=("side",))
        self._variant_names: set = set()
        # Dtype strings mirrored out of the engine at sync time; ride
        # the snapshot (loadgen's report) since gauges hold floats.
        self._weight_dtype = "native"
        self._draft_weight_dtype = ""
        self._kv_dtype = ""
        self._peak_lock = threading.Lock()
        self._last_engine_stats: dict = {}

    # -- recording (scheduler hot path) -----------------------------------

    def record_ttft(self, seconds: float) -> None:
        self.ttft.observe(seconds)

    def record_round(self, seconds: float, tokens: int) -> None:
        """One engine decode round that produced ``tokens`` valid tokens."""
        if tokens > 0:
            self._tokens_out.inc(int(tokens))
            self.per_token.observe(seconds / tokens)

    def record_queue_depth(self, depth: int) -> None:
        self.queue_depth.observe(float(depth))
        self._queue_depth_gauge.set(float(depth))
        with self._peak_lock:
            if depth > self._queue_depth_peak.value:
                self._queue_depth_peak.set(float(depth))

    def record_occupancy(self, frac: float) -> None:
        self.occupancy.observe(float(frac))
        self._occupancy_gauge.set(float(frac))

    def record_lane_depths(self, depths) -> None:
        for lane, depth in enumerate(depths):
            self._lane_depth.labels(lane=str(lane)).set(float(depth))

    def record_completed(self, variant: str = "") -> None:
        self._completed.inc()
        self._variant_names.add(variant)
        self._variant_requests.labels(variant=variant).inc()

    def record_shed(self) -> None:
        self._shed.inc()

    def record_handoff(self, outcome: str) -> None:
        """Count one tier-handoff event (see the counter's help text)."""
        self._handoff_outcomes.add(str(outcome))
        self._handoff.labels(outcome=str(outcome)).inc()

    def handoff_count(self, outcome: str) -> int:
        return int(self._handoff.labels(outcome=str(outcome)).value)

    def record_handoff_bytes(self, nbytes: int, *, compressed: bool) -> None:
        label = "true" if compressed else "false"
        self._handoff_bytes.labels(compressed=label).inc(int(nbytes))

    def handoff_bytes(self) -> dict:
        return {
            label: int(self._handoff_bytes.labels(compressed=label).value)
            for label in ("true", "false")
        }

    def record_handoff_chunk_ms(self, ms: float) -> None:
        self._handoff_chunk_ms.observe(float(ms))

    def record_handoff_throughput(self, peer: str, bps: float) -> None:
        self._handoff_peers.add(str(peer))
        self._handoff_tp.labels(peer=str(peer)).set(float(bps))

    def record_handoff_stall(self, side: str, seconds: float) -> None:
        """One driver-thread block attributable to a handoff transfer:
        export capture on the prefill tier, an import scatter event on
        the decode tier (v1 pays one whole-slot event, v2 one per
        chunk), and — v2 only — the post-transfer ``commit`` block
        (slot acquire + bind + register adoption), which is the only
        decode-tier stall left AFTER the last wire byte arrives."""
        side = str(side)
        seconds = max(0.0, float(seconds))
        self._handoff_stall_total.labels(side=side).inc(seconds)
        self._handoff_stall_counts.labels(side=side).inc()
        with self._peak_lock:
            if seconds > self._handoff_stall_max.labels(side=side).value:
                self._handoff_stall_max.labels(side=side).set(seconds)

    def handoff_stall(self, side: str) -> dict:
        side = str(side)
        return {
            "total_s": float(
                self._handoff_stall_total.labels(side=side).value),
            "max_s": float(
                self._handoff_stall_max.labels(side=side).value),
            "events": int(
                self._handoff_stall_counts.labels(side=side).value),
        }

    def record_swap(self, outcome: str) -> None:
        """Count one hot-swap attempt (``"ok"`` or ``"rollback"``)."""
        self._swap_total.labels(outcome=str(outcome)).inc()

    def record_weight_version(self, step: int) -> None:
        self._weight_version.set(float(step))

    def sync_engine(self, engine) -> None:
        """Mirror the engine's cumulative fast-path stats into registry
        instruments (called once per scheduler round). Counters advance by
        delta against the last sync; rate gauges are recomputed from the
        cumulative totals; pool gauges are point-in-time."""
        stats = getattr(engine, "stats", None)
        if not stats:
            return
        for key, counter in (
            ("prefix_tokens_matched", self._prefix_matched),
            ("prefix_tokens_total", self._prefix_total),
            ("prefill_chunks", self._prefill_chunks),
        ):
            delta = int(stats.get(key, 0)) - self._last_engine_stats.get(
                key, 0)
            if delta > 0:
                counter.inc(delta)
                self._last_engine_stats[key] = int(stats[key])
        tdt = str(getattr(engine, "weight_dtype", "native"))
        ddt = str(getattr(engine, "draft_weight_dtype", "") or "none")
        for drafter in ("ngram", "model"):
            for suffix, family in (
                ("accepted", self._spec_accepted),
                ("proposed", self._spec_proposed),
            ):
                key = f"spec_drafts_{suffix}_{drafter}"
                delta = (int(stats.get(key, 0))
                         - self._last_engine_stats.get(key, 0))
                if delta > 0:
                    family.labels(drafter=drafter, target_dtype=tdt,
                                  draft_dtype=ddt).inc(delta)
                    self._last_engine_stats[key] = int(stats[key])
            if hasattr(engine, "spec_accept_rate_for"):
                self._spec_accept_rate_by.labels(drafter=drafter).set(
                    float(engine.spec_accept_rate_for(drafter)))
        self._prefix_hit_rate.set(float(engine.prefix_hit_rate))
        self._spec_accept_rate.set(float(engine.spec_accept_rate))
        self._prefill_budget.set(
            float(getattr(engine, "prefill_chunk_tokens", -1)))
        self._prefill_last_iter.set(
            float(stats.get("prefill_tokens_last_iter", 0)))
        pool = getattr(engine, "pool", None)
        if getattr(engine, "paged", False) and pool is not None:
            self._pages_free.set(float(pool.pages_free))
            self._page_occupancy.set(float(pool.occupancy))
        if pool is not None and hasattr(pool, "hbm_bytes_per_slot"):
            self._hbm_per_slot.set(float(pool.hbm_bytes_per_slot))
        self._mesh_tp.set(float(getattr(engine, "tp", 1)))
        if hasattr(engine, "hbm_bytes_per_device"):
            self._hbm_per_device.set(float(engine.hbm_bytes_per_device))
        if hasattr(engine, "weight_bytes_per_device"):
            self._weight_bytes_per_device.set(
                float(engine.weight_bytes_per_device))
        if hasattr(engine, "kv_bytes_per_token"):
            self._kv_bytes_per_token.set(float(engine.kv_bytes_per_token))
        kvd = str(getattr(engine, "kv_dtype", "") or "")
        if kvd and kvd != self._kv_dtype:
            if self._kv_dtype:
                self._kv_dtype_info.labels(dtype=self._kv_dtype).set(0.0)
            self._kv_dtype_info.labels(dtype=kvd).set(1.0)
            self._kv_dtype = kvd
        if hasattr(engine, "spec_accept_per_verify"):
            self._spec_accept_per_verify.set(
                float(engine.spec_accept_per_verify))
        samples = sorted(getattr(engine, "accept_samples", ()) or ())
        if samples:
            self._spec_apv_p50.set(float(samples[len(samples) // 2]))
            self._spec_apv_p99.set(
                float(samples[min(len(samples) - 1,
                                  (len(samples) * 99) // 100)]))
        self._weight_dtype = tdt
        self._draft_weight_dtype = str(
            getattr(engine, "draft_weight_dtype", ""))

    # -- counter readout (kept as plain ints for callers/tests) ------------

    @property
    def completed(self) -> int:
        return int(self._completed.value)

    @property
    def shed(self) -> int:
        return int(self._shed.value)

    @property
    def tokens_out(self) -> int:
        return int(self._tokens_out.value)

    @property
    def queue_depth_peak(self) -> int:
        return int(self._queue_depth_peak.value)

    @property
    def prefix_hit_rate(self) -> float:
        return float(self._prefix_hit_rate.value)

    @property
    def spec_accept_rate(self) -> float:
        return float(self._spec_accept_rate.value)

    @property
    def weight_version(self) -> int:
        return int(self._weight_version.value)

    def swap_count(self, outcome: str) -> int:
        return int(self._swap_total.labels(outcome=str(outcome)).value)

    def variant_requests(self) -> dict:
        """Completed-request counts per variant seen so far."""
        return {
            v: int(self._variant_requests.labels(variant=v).value)
            for v in sorted(self._variant_names)
        }

    # -- readout ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready view (the /metrics.json endpoint, loadgen's report)."""
        def ms(h) -> dict:
            s = h.summary()
            return {k: (v * 1e3 if k != "count" else v) for k, v in s.items()}

        return {
            "completed": self.completed,
            "shed": self.shed,
            "tokens_out": self.tokens_out,
            "queue_depth_peak": self.queue_depth_peak,
            "queue_depth": self.queue_depth.summary(),
            "slot_occupancy": self.occupancy.summary(),
            "ttft_ms": ms(self.ttft),
            "per_token_ms": ms(self.per_token),
            "prefix_hit_rate": self.prefix_hit_rate,
            "spec_accept_rate": self.spec_accept_rate,
            "spec_accept_rate_by_drafter": {
                d: float(self._spec_accept_rate_by.labels(drafter=d).value)
                for d in ("ngram", "model")
            },
            "prefill_chunks": int(self._prefill_chunks.value),
            "prefill_tokens_budget": self._prefill_budget.value,
            "kv_pages_free": self._pages_free.value,
            "hbm_bytes_per_slot": self._hbm_per_slot.value,
            "weight_bytes_per_device": self._weight_bytes_per_device.value,
            "weight_dtype": self._weight_dtype,
            "draft_weight_dtype": self._draft_weight_dtype,
            "kv_dtype": self._kv_dtype,
            "kv_bytes_per_token": self._kv_bytes_per_token.value,
            "spec_accept_per_verify": self._spec_accept_per_verify.value,
            "spec_accepted_per_verify_p50": self._spec_apv_p50.value,
            "spec_accepted_per_verify_p99": self._spec_apv_p99.value,
            "weight_version": self.weight_version,
            "variant_requests": self.variant_requests(),
            "handoff": {
                o: self.handoff_count(o)
                for o in sorted(self._handoff_outcomes)
            },
            "handoff_bytes": self.handoff_bytes(),
            "handoff_chunk_ms": self._handoff_chunk_ms.summary(),
            "handoff_stall": {
                side: self.handoff_stall(side)
                for side in ("export", "import", "commit")
            },
            "handoff_throughput_bytes_per_s": {
                p: float(self._handoff_tp.labels(peer=p).value)
                for p in sorted(self._handoff_peers)
            },
            "swaps": {
                "ok": self.swap_count("ok"),
                "rollback": self.swap_count("rollback"),
            },
        }

    def publish(self, writer, step: int) -> None:
        """Emit the current state into a ``utils/summary.SummaryWriter``."""
        scalars = {
            "serve/completed": float(self.completed),
            "serve/shed": float(self.shed),
            "serve/tokens_out": float(self.tokens_out),
            "serve/queue_depth_peak": float(self.queue_depth_peak),
            "serve/ttft_p99_ms": self.ttft.percentile(99) * 1e3,
            "serve/per_token_p50_ms": self.per_token.percentile(50) * 1e3,
        }
        writer.add_scalars(scalars, step)
