"""Lane-scheduled continuous batching: priority lanes + per-client
weighted fairness + typed admission control.

This package's copy of ``distributed_tensorflow_tpu/serve/scheduler.py`` on
this package's engine, without the variant table (``variants=``) and the
disaggregated handoff roles (``role``, ``handoff=``), which raise "not
ported yet".

The scheduler is the single thread that owns the engine. Each ``step()``
is one serving iteration in the Orca sense:

  1. **shed** queued requests whose deadline passed while waiting,
  2. **admit** queued requests into free slots (prefill + first token —
     TTFT is measured here), releasing immediately if the first token
     already finishes the request,
  3. **decode** one engine round over every active slot,
  4. **complete** slots the round finished and free them — the very next
     ``step()`` refills those slots from the queue.

Admission order: requests queue into one of three **priority lanes** (0 =
interactive, 1 = normal, 2 = batch) drained by weighted interleave — under
contention lane k gets ``lane_weights[k]`` admissions per cycle. Within a
lane, **per-client deficit round-robin** (keyed on ``Request.client_id``,
optionally weighted) keeps one chatty client from monopolizing the lane:
each client's requests stay FIFO, but admissions rotate across clients in
proportion to their weight. One anonymous client on one lane is FCFS.

Load-shed is deterministic and TYPED — callers always get a
:class:`Completion` or a :class:`Rejection` with a machine-readable
``reason`` (``queue_full`` at submit, ``deadline`` at admission sweep,
``invalid`` for malformed params, ``shutting_down`` at stop). ``submit``
either rejects synchronously or enqueues, and
``PendingRequest.result(timeout)`` / ``stream_events(timeout)`` are the
only waits.

Deadlines govern QUEUE WAIT only: a request admitted before its deadline
runs to completion.

Streaming (``Request.stream=True``): the handle grows a per-request event
queue the scheduler feeds as tokens materialize — the first token at
admission, then one batch per engine round — ending with the terminal
outcome, which ``serve/server.py`` turns into SSE.

Draining (``begin_drain``): stop accepting (``/healthz`` flips 503) while
the loop keeps serving queued + in-flight work.

Iteration-boundary callbacks (``at_boundary``) run on the driver thread at
the top of ``step()`` and in the background loop's idle branch.
"""

from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from distributed_tensorflow_tpu_torch.serve.engine import SlotEngine
from distributed_tensorflow_tpu_torch.serve.kv_pool import InsufficientPages

__all__ = [
    "Request",
    "Completion",
    "Rejection",
    "PendingRequest",
    "Scheduler",
    "NUM_LANES",
    "DEFAULT_LANE_WEIGHTS",
]

# Lane 0 = interactive, 1 = normal (default), 2 = batch/background.
NUM_LANES = 3
# Admissions per weighted-interleave cycle under full contention: 8:4:1.
DEFAULT_LANE_WEIGHTS = (8, 4, 1)


@dataclass(frozen=True)
class Request:
    """One generation request. ``deadline_s`` is a RELATIVE queue-wait
    budget from submit time (None = wait forever); see the module
    docstring for why it only sheds while queued. ``priority`` picks the
    lane (0 interactive … 2 batch), ``client_id`` the fairness key
    (empty = one shared anonymous client), ``stream`` requests
    per-token delivery through the handle."""

    prompt: tuple
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    eos_id: int | None = None
    deadline_s: float | None = None
    request_id: str = ""
    priority: int = 1
    client_id: str = ""
    stream: bool = False
    # Explicit variant pin (requires a VariantTable; unknown names get a
    # typed "invalid" rejection). Empty = resolve from client_id lanes.
    variant: str = ""


@dataclass(frozen=True)
class Completion:
    request_id: str
    tokens: tuple  # generated tokens only (prompt excluded), eos included
    ttft_s: float
    latency_s: float
    finish_reason: str  # "length" | "eos"
    # Attribution: which weight variant served this request and which
    # checkpoint step those weights came from (pinned at admission, so a
    # mid-flight hot swap of OTHER requests never relabels this one).
    variant: str = ""
    weight_version: int = 0


@dataclass(frozen=True)
class Rejection:
    request_id: str
    # "queue_full" | "deadline" | "invalid" | "shutting_down" |
    # "insufficient_pages" (decode tier cannot back a handoff import) |
    # "upstream_died" (decode peer lost after the handoff was accepted)
    reason: str
    detail: str = ""


@dataclass
class PendingRequest:
    """Submit-side handle: ``result(timeout)`` blocks until the scheduler
    posts a Completion or Rejection (never a hang under shed — every
    terminal path posts exactly once). For ``stream`` requests,
    ``stream_events(timeout)`` yields ``("tokens", [ints])`` batches as
    the engine produces them and always terminates with
    ``("done", outcome)`` — the same no-hang contract, per token."""

    request: Request
    submitted_at: float
    variant: str = ""  # resolved at submit; the queue it waits in
    _event: threading.Event = field(default_factory=threading.Event)
    _outcome: Completion | Rejection | None = None
    _stream_q: _queue.Queue | None = None

    def finish(self, outcome: Completion | Rejection) -> None:
        self._outcome = outcome
        if self._stream_q is not None:
            self._stream_q.put(("done", outcome))
        self._event.set()

    def push_tokens(self, tokens) -> None:
        """Feed freshly produced tokens to a streaming consumer (no-op
        for non-streaming handles)."""
        if self._stream_q is not None and tokens:
            self._stream_q.put(("tokens", [int(t) for t in tokens]))

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Completion | Rejection:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id!r} not finished "
                f"within {timeout}s"
            )
        assert self._outcome is not None
        return self._outcome

    def stream_events(self, timeout: float | None = None):
        """Yield ``("tokens", [ints])`` then a final ``("done", outcome)``.
        ``timeout`` bounds the gap between consecutive events; exceeding
        it raises TimeoutError rather than hanging the consumer."""
        if self._stream_q is None:
            raise RuntimeError(
                "stream_events() on a non-streaming request "
                "(submit with Request(stream=True))"
            )
        while True:
            try:
                kind, payload = self._stream_q.get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(
                    f"request {self.request.request_id!r}: no stream event "
                    f"within {timeout}s"
                ) from None
            yield kind, payload
            if kind == "done":
                return


class _FairQueue:
    """Priority lanes + per-client deficit round-robin (DRR).

    NOT thread-safe — the Scheduler's lock guards every call. Each lane
    holds per-client FIFO deques plus a service ring; ``pop`` first picks
    a lane by weighted interleave (credits refilled when the nonempty
    lanes run dry), then the lane's next client by DRR: a client's
    deficit grows by its weight each ring pass and each admission costs
    1, so admissions converge to weight-proportional shares while each
    client's own requests stay strictly FIFO."""

    def __init__(self, lane_weights=DEFAULT_LANE_WEIGHTS, client_weights=None):
        if len(lane_weights) != NUM_LANES or any(w < 1 for w in lane_weights):
            raise ValueError(
                f"lane_weights must be {NUM_LANES} integers >= 1, "
                f"got {lane_weights!r}"
            )
        self.lane_weights = tuple(int(w) for w in lane_weights)
        self.client_weights = dict(client_weights or {})
        if any(w <= 0 for w in self.client_weights.values()):
            raise ValueError(
                f"client weights must be > 0, got {self.client_weights!r}"
            )
        self._queues = [dict() for _ in range(NUM_LANES)]  # cid -> deque
        self._rings = [deque() for _ in range(NUM_LANES)]  # service order
        self._deficits = [dict() for _ in range(NUM_LANES)]
        self._credits = list(self.lane_weights)
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def depths(self) -> tuple[int, ...]:
        return tuple(
            sum(len(q) for q in lane.values()) for lane in self._queues
        )

    def _weight(self, client_id: str) -> float:
        return float(self.client_weights.get(client_id, 1.0))

    def push(self, pending: PendingRequest) -> None:
        lane = pending.request.priority
        cid = pending.request.client_id
        qs = self._queues[lane]
        if cid not in qs:
            qs[cid] = deque()
            self._rings[lane].append(cid)
            self._deficits[lane][cid] = 0.0
        qs[cid].append(pending)
        self._len += 1

    def push_front(self, pending: PendingRequest) -> None:
        """Requeue at the HEAD of its client's deque and move the client
        to the front of the lane's service ring (with enough deficit to be
        served immediately). Used when admission popped a request the
        paged pool cannot back yet — the request keeps its place instead
        of paying the fairness rotation twice. The one-step ring bias this
        introduces is bounded: at most one requeue per admission attempt,
        and the request it favors is the one that was already chosen."""
        lane = pending.request.priority
        cid = pending.request.client_id
        qs = self._queues[lane]
        ring = self._rings[lane]
        defs = self._deficits[lane]
        if cid not in qs:
            qs[cid] = deque()
            defs[cid] = 0.0
            ring.appendleft(cid)
        else:
            ring.remove(cid)
            ring.appendleft(cid)
        defs[cid] = max(defs[cid], 1.0)
        qs[cid].appendleft(pending)
        self._len += 1

    def _drop_client(self, lane: int, cid: str) -> None:
        del self._queues[lane][cid]
        del self._deficits[lane][cid]
        self._rings[lane].remove(cid)

    def _pop_lane(self, lane: int) -> PendingRequest:
        ring = self._rings[lane]
        qs = self._queues[lane]
        defs = self._deficits[lane]
        while True:
            cid = ring[0]
            if defs[cid] >= 1.0:
                defs[cid] -= 1.0
                q = qs[cid]
                pending = q.popleft()
                if not q:
                    # A departing client forfeits its remaining deficit —
                    # rejoining starts fresh (no banking idle credit).
                    self._drop_client(lane, cid)
                elif defs[cid] < 1.0:
                    ring.rotate(-1)
                return pending
            defs[cid] += self._weight(cid)
            ring.rotate(-1)

    def pop(self) -> PendingRequest | None:
        if self._len == 0:
            return None
        nonempty = [i for i in range(NUM_LANES) if self._queues[i]]
        lane = next((i for i in nonempty if self._credits[i] > 0), None)
        if lane is None:
            self._credits = list(self.lane_weights)
            lane = nonempty[0]
        self._credits[lane] -= 1
        self._len -= 1
        return self._pop_lane(lane)

    def remove_if(self, pred) -> list[PendingRequest]:
        """Remove (and return) every queued request matching ``pred`` —
        the deadline shed sweep. Per-client FIFO order is preserved."""
        removed = []
        for lane in range(NUM_LANES):
            qs = self._queues[lane]
            for cid in list(qs):
                kept = deque()
                for pending in qs[cid]:
                    if pred(pending):
                        removed.append(pending)
                    else:
                        kept.append(pending)
                if kept:
                    qs[cid] = kept
                else:
                    self._drop_client(lane, cid)
        self._len -= len(removed)
        return removed

    def drain_all(self) -> list[PendingRequest]:
        return self.remove_if(lambda _: True)


class Scheduler:
    """Lane-scheduled continuous-batching scheduler over one
    :class:`SlotEngine`.

    ``submit()`` is thread-safe (the HTTP server calls it from handler
    threads); the engine is driven only from ``step()`` /
    ``run_until_idle()`` / the ``start()`` background loop — one driver at
    a time by contract, and that thread makes every device call.
    """

    def __init__(
        self,
        engine: SlotEngine,
        *,
        max_queue_depth: int = 64,
        metrics=None,
        clock=time.monotonic,
        lane_weights=DEFAULT_LANE_WEIGHTS,
        client_weights=None,
        variants=None,
        role: str = "mixed",
        handoff=None,
    ):
        if variants is not None:
            raise NotImplementedError("variant tables (serve/deploy) are not ported yet")
        if role != "mixed" or handoff is not None:
            if role not in ("prefill", "decode", "mixed"):
                raise ValueError(f"role must be prefill|decode|mixed, got {role!r}")
            raise NotImplementedError(
                f"the disaggregated {role!r} role (handoff) is not ported yet")
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got {max_queue_depth}")
        self.engine = engine
        self.max_queue_depth = int(max_queue_depth)
        self.metrics = metrics
        self.clock = clock
        self.variants = None
        self.role = role
        self.handoff = None
        self._queue = _FairQueue(lane_weights, client_weights)
        self._lock = threading.Lock()  # guards the queue and accept/drain state
        self._accepting = True
        self._draining = False
        self._drain_deadline: float | None = None
        self._inflight: dict[int, _InFlight] = {}
        self._ids = itertools.count()
        self._boundary: deque = deque()  # thread-safe append/popleft
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- submit side (any thread) -----------------------------------------

    def submit(self, request: Request) -> PendingRequest:
        """Enqueue or reject NOW. The returned handle always terminates."""
        now = self.clock()
        pending = PendingRequest(request=request, submitted_at=now)
        if request.stream:
            pending._stream_q = _queue.Queue()
        if not request.request_id:
            request = Request(**{**request.__dict__, "request_id": f"r{next(self._ids)}"})
            pending.request = request
        err = self._validate(request)
        if err is None and request.variant:
            err = (f"variant {request.variant!r} requested but no variant "
                   f"table is configured")
        if err is not None:
            pending.finish(Rejection(request.request_id, "invalid", err))
            self._count_shed()
            return pending
        with self._lock:
            if not self._accepting:
                pending.finish(
                    Rejection(request.request_id, "shutting_down",
                              "scheduler is draining" if self._draining
                              else "scheduler is stopping")
                )
                self._count_shed()
                return pending
            depth = len(self._queue)
            if depth >= self.max_queue_depth:
                pending.finish(Rejection(request.request_id, "queue_full",
                                         f"queue depth {depth} >= {self.max_queue_depth}"))
                self._count_shed()
                return pending
            self._queue.push(pending)
            depth += 1
            lane_depths = self._queue.depths()
        if self.metrics is not None:
            self.metrics.record_queue_depth(depth)
            self.metrics.record_lane_depths(lane_depths)
        return pending

    def _validate(self, r: Request) -> str | None:
        e = self.engine
        p = len(r.prompt)
        if p < 1:
            return "empty prompt"
        cap = getattr(e, "max_prompt_len", e.prefill_len)
        if p > cap:
            return f"prompt length {p} > max prompt length {cap}"
        if r.max_new_tokens < 1:
            return f"max_new_tokens {r.max_new_tokens} < 1"
        if p + r.max_new_tokens > e.max_len:
            return f"prompt {p} + {r.max_new_tokens} new > max_len {e.max_len}"
        if r.deadline_s is not None and r.deadline_s < 0:
            return f"negative deadline_s {r.deadline_s}"
        if (isinstance(r.priority, bool) or not isinstance(r.priority, int)
                or not 0 <= r.priority < NUM_LANES):
            return f"priority {r.priority!r} outside [0, {NUM_LANES})"
        return None

    def _count_shed(self) -> None:
        if self.metrics is not None:
            self.metrics.record_shed()

    # -- engine-driver side (one thread) ----------------------------------

    def at_boundary(self, fn) -> None:
        """Run ``fn()`` on the driver thread at the next iteration boundary.
        Thread-safe; callbacks run once, in submission order."""
        self._boundary.append(fn)

    def _run_boundary(self) -> None:
        while True:
            try:
                fn = self._boundary.popleft()
            except IndexError:
                return
            fn()

    def step(self) -> int:
        """One serving iteration (boundary callbacks → shed → admit →
        decode → complete). Returns the requests completed this iteration."""
        self._run_boundary()
        now = self.clock()
        self._shed_expired(now)
        self._admit(now)
        if self.metrics is not None:
            self.metrics.record_occupancy(self.engine.utilization)
            self.metrics.sync_engine(self.engine)
        if self.engine.active_count == 0 and self.engine.prefilling_count == 0:
            return 0
        t0 = self.clock()
        toks, valid, done = self.engine.step()
        round_s = self.clock() - t0
        produced = 0
        round_toks: dict[int, list] = {}
        for k in range(toks.shape[0]):
            for slot, fl in self._inflight.items():
                if valid[k, slot]:
                    tok = int(toks[k, slot])
                    fl.tokens.append(tok)
                    round_toks.setdefault(slot, []).append(tok)
                    produced += 1
        for slot, new in round_toks.items():
            fl = self._inflight[slot]
            if fl.ttft_s is None:
                # Chunked prefill deferred the first token to this round.
                fl.ttft_s = self.clock() - fl.pending.submitted_at
                if self.metrics is not None:
                    self.metrics.record_ttft(fl.ttft_s)
            fl.pending.push_tokens(new)
        if self.metrics is not None:
            self.metrics.record_round(round_s, produced)
        completed = 0
        for slot in np.nonzero(done)[0]:
            self._complete(int(slot))
            completed += 1
        return completed

    def _shed_expired(self, now: float) -> None:
        with self._lock:
            expired = self._queue.remove_if(
                lambda p: (p.request.deadline_s is not None
                           and now - p.submitted_at > p.request.deadline_s))
        for pending in expired:
            r = pending.request
            pending.finish(Rejection(
                r.request_id, "deadline",
                f"queued {now - pending.submitted_at:.3f}s > deadline {r.deadline_s}s"))
            self._count_shed()

    def _admit(self, now: float) -> None:
        while True:
            with self._lock:
                if not len(self._queue):
                    return
                slot = self.engine.acquire_slot()
                if slot is None:
                    return
                pending = self._queue.pop()
            r = pending.request
            try:
                first, finished = self.engine.start(
                    slot, r.prompt, max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
                    seed=r.seed, eos_id=r.eos_id,
                )
            except InsufficientPages:
                # The paged pool is full right now: requeue at the head of
                # its lane and stop admitting this round — every request
                # holds all its pages up front, so pages free as in-flight
                # requests complete.
                self.engine.release(slot)
                with self._lock:
                    self._queue.push_front(pending)
                return
            except Exception as exc:  # _validate should prevent this
                self.engine.release(slot)
                pending.finish(Rejection(r.request_id, "invalid", str(exc)))
                self._count_shed()
                continue
            done_at = self.clock()
            wv = int(getattr(self.engine, "weight_version", 0))
            if first is None:
                # Chunked prefill scheduled: the first token (and TTFT)
                # arrives from a later engine round.
                self._inflight[slot] = _InFlight(pending, None, done_at, None, "", wv)
                continue
            ttft = done_at - pending.submitted_at
            if self.metrics is not None:
                self.metrics.record_ttft(ttft)
            fl = _InFlight(pending, first, done_at, ttft, "", wv)
            pending.push_tokens([int(first)])
            if finished:
                self.engine.release(slot)
                self._finish_completion(fl, done_at)
            else:
                self._inflight[slot] = fl

    def _complete(self, slot: int) -> None:
        fl = self._inflight.pop(slot)
        self.engine.release(slot)
        self._finish_completion(fl, self.clock())

    def _finish_completion(self, fl: _InFlight, now: float) -> None:
        r = fl.pending.request
        reason = ("eos" if r.eos_id is not None and fl.tokens and fl.tokens[-1] == r.eos_id
                  else "length")
        fl.pending.finish(Completion(
            request_id=r.request_id, tokens=tuple(fl.tokens), ttft_s=fl.ttft_s,
            latency_s=now - fl.pending.submitted_at, finish_reason=reason,
            variant=fl.variant, weight_version=fl.weight_version,
        ))
        if self.metrics is not None:
            self.metrics.record_completed(variant=fl.variant)

    def run_until_idle(self, max_steps: int | None = None) -> int:
        """Drive ``step()`` until queue and slots are empty; returns total
        completions. ``max_steps`` bounds runaway loops in tests."""
        total = 0
        steps = 0
        while True:
            self._run_boundary()
            with self._lock:
                queued = len(self._queue)
            if queued == 0 and not self._inflight:
                return total
            total += self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"not idle after {max_steps} steps "
                    f"({queued} queued, {len(self._inflight)} in flight)")

    # -- background loop (serve_lm) ---------------------------------------

    def start(self, poll_s: float = 0.001) -> None:
        """Run the serving loop on a daemon thread (the HTTP server's
        submit side stays on its own threads)."""
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self._run_boundary()
                with self._lock:
                    idle = not len(self._queue)
                if idle and not self._inflight:
                    self._stop.wait(poll_s)
                    continue
                self.step()

        self._thread = threading.Thread(target=loop, name="serve-scheduler", daemon=True)
        self._thread.start()

    def begin_drain(self, deadline_s: float | None = None) -> None:
        """Graceful-shutdown phase 1: refuse NEW submits (typed
        ``shutting_down``; ``/healthz`` flips 503) while the loop keeps
        serving everything already accepted. ``deadline_s`` is advisory."""
        with self._lock:
            self._accepting = False
            self._draining = True
            self._drain_deadline = (self.clock() + deadline_s if deadline_s is not None
                                    else None)

    def drain_remaining_s(self) -> float | None:
        """Seconds left before the announced drain deadline (None when not
        draining or no deadline was given; floors at 0.0)."""
        with self._lock:
            if not self._draining or self._drain_deadline is None:
                return None
            return max(0.0, self._drain_deadline - self.clock())

    @property
    def idle(self) -> bool:
        with self._lock:
            queued = len(self._queue)
        return queued == 0 and not self._inflight

    def stop(self, timeout: float = 5.0) -> None:
        """Stop accepting, halt the loop, and shed anything unfinished
        (typed ``shutting_down``) so no caller is left hanging."""
        with self._lock:
            self._accepting = False
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout)
            self._thread = None
        with self._lock:
            leftovers = self._queue.drain_all()
        leftovers.extend(fl.pending for fl in self._inflight.values())
        for slot in list(self._inflight):
            del self._inflight[slot]
            self.engine.release(slot)
        for pending in leftovers:
            if not pending.done():
                pending.finish(Rejection(pending.request.request_id, "shutting_down",
                                         "scheduler stopped before completion"))
                self._count_shed()

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def lane_depths(self) -> tuple[int, ...]:
        with self._lock:
            return self._queue.depths()

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    @property
    def accepting(self) -> bool:
        """False once ``begin_drain()`` or ``stop()`` has begun."""
        with self._lock:
            return self._accepting

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    @property
    def loop_running(self) -> bool:
        """True while the ``start()`` background loop thread is alive."""
        return self._thread is not None and self._thread.is_alive()


class _InFlight:
    """Host-side accumulation for a request occupying a slot."""

    __slots__ = ("pending", "tokens", "started_at", "ttft_s", "variant", "weight_version")

    def __init__(self, pending, first_token, started_at, ttft_s, variant="", weight_version=0):
        self.pending = pending
        # first_token/ttft_s are None while the slot is PREFILLING.
        self.tokens = [] if first_token is None else [int(first_token)]
        self.started_at = started_at
        self.ttft_s = ttft_s
        self.variant = variant
        self.weight_version = int(weight_version)
