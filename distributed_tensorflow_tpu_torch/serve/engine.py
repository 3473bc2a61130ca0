"""Continuous-batching decode engine over one model on one device.

Counterpart of ``distributed_tensorflow_tpu/serve/engine.py::SlotEngine``
without speculation, weight swap, slot export/import and the sharded
engine. The engine runs one of two KV layouts behind the same slot API:

* ``page_size=0`` — the monolithic layout: per-slot worst-case rows in a
  :class:`~distributed_tensorflow_tpu_torch.serve.kv_pool.SlotKVPool`.

* ``page_size>0`` (default) — the paged layout: one physical page pool
  (:class:`~distributed_tensorflow_tpu_torch.serve.kv_pool.PagedKVPool`)
  plus host page tables. Where the JAX programs gather each slot's whole
  logical ``(kv, max_len, dh)`` cache from its table row and scatter the
  touched pages back, this engine writes the new keys and values straight
  into their pages (unbound table entries and finished lanes write into
  the trash page) and reads, for the lanes it runs, only the pages up to
  the longest of their lengths: the same keys under the same mask, without
  reading the pool's unused rows.

Programs (the "0 recompiles after warmup" contract): eager torch compiles
nothing, so the engine counts the distinct signatures it has run — one
per (program, sampling variant, operand shape) the JAX engine would have
compiled: a prefill at each bucket width, and the decode round over the
slot batch. :meth:`warmup` runs every one of them; after it
:meth:`compile_count` must never grow, and the optional
``RecompileSentinel`` (poll mode) turns growth into
``recompile_events_total``.

* **prefill** — one causal forward of a ``(1, width)`` prompt, ``width``
  the narrowest bucket (a fixed set, largest ``prefill_len``) holding the
  real tokens, then the request's first token taken at its true last
  prompt position. Under paging the forward starts at ``len = m0`` where
  ``m0`` tokens of KV were adopted from the prefix cache: only the tail is
  computed.
* **decode round** — ``steps_per_sync`` micro-steps over the active
  slots, per-slot lengths, per-slot greedy or sampled picks, lanes that
  finish masked for the rest of the round. The round's registers go to
  the device in one copy and its tokens come back in one.
* **chunked prefill** (``prefill_chunk_tokens``, paged only) — a prompt
  whose post-adoption tail exceeds the chunk width is fed across engine
  iterations through the bucket programs, one suffix-aligned final chunk
  last, while co-resident slots keep decoding.

Correctness invariant for slot reuse: a step at length ``len`` writes
position ``len`` BEFORE attending keys ``0..len``, so every key a request
reads was written by that request; freed slots and pages are never zeroed.

Sampling: a sampled pick at a slot's ``made``-th token draws from
``models/decoding.py::stream_uniforms(seed, made)``: the stream is a
function of the request's seed, whatever shares the batch. Greedy rows
take the argmax.

The engine is single-threaded by contract: one thread owns it and makes
every device call, on the engine's device.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.models.decoding import (
    compute_copy,
    sample_logits_batched,
    stream_uniforms,
)
from distributed_tensorflow_tpu_torch.serve.kv_pool import (
    TRASH_PAGE,
    InsufficientPages,
    PagedKVPool,
    PrefixCache,
    SlotKVPool,
)
from distributed_tensorflow_tpu_torch.utils.device import resolve_device

__all__ = ["SlotEngine", "ShardedSlotEngine"]

_NOT_PORTED = "is not ported yet"


class _PagedView:
    """KV view of ``n`` lanes over the page pool: ``tables`` (n, P) page ids
    (the first P pages of each lane's row), ``lengths`` (n,) filled
    prefixes; ``live`` (n,) False sends a lane's writes to the trash page."""

    def __init__(self, layers, tables, lengths, page_size, live=None):
        self.layers, self.tables, self.lengths = layers, tables, lengths
        self.page_size, self.live = page_size, live
        self.extent = tables.shape[1] * page_size
        self._where = None  # (page, offset) of the written positions, shared by the layers

    def write(self, layer, k, v):
        if self._where is None:
            pos = self.lengths[:, None] + torch.arange(k.shape[2], device=k.device)
            page = torch.gather(self.tables, 1, pos // self.page_size)
            if self.live is not None:
                page = torch.where(self.live[:, None], page, TRASH_PAGE)
            self._where = (page, pos % self.page_size)
        page, off = self._where
        buf = self.layers[layer]
        buf["k"][page, :, off] = k.transpose(1, 2).to(buf["k"].dtype)
        buf["v"][page, :, off] = v.transpose(1, 2).to(buf["v"].dtype)

    def read(self, layer):
        n, p = self.tables.shape
        out = []
        for name in ("k", "v"):
            g = self.layers[layer][name][self.tables]  # (n, P, kv, ps, dh)
            f = torch.empty((n, g.shape[2], p, g.shape[3], g.shape[4]), dtype=torch.float32,
                            device=g.device)
            f.copy_(g.permute(0, 2, 1, 3, 4))
            out.append(f.view(n, g.shape[2], p * g.shape[3], g.shape[4]))
        return out[0], out[1]


class _RowView:
    """KV view of ``n`` lanes over the monolithic pool: ``rows`` (n,) slot
    rows, keys read up to ``extent``."""

    def __init__(self, layers, rows, lengths, extent):
        self.layers, self.rows, self.lengths, self.extent = layers, rows, lengths, extent
        self._pos = None  # the written positions, shared by the layers

    def write(self, layer, k, v):
        if self._pos is None:
            self._pos = self.lengths[:, None] + torch.arange(k.shape[2], device=k.device)
        pos = self._pos
        buf = self.layers[layer]
        buf["k"][self.rows[:, None], :, pos] = k.transpose(1, 2).to(buf["k"].dtype)
        buf["v"][self.rows[:, None], :, pos] = v.transpose(1, 2).to(buf["v"].dtype)

    def read(self, layer):
        buf = self.layers[layer]
        return (buf["k"][self.rows, :, : self.extent].float(),
                buf["v"][self.rows, :, : self.extent].float())


class SlotEngine:
    """Fixed-capacity continuous-batching engine over one model.

    ``acquire_slot`` → ``start`` (prefill, returns the first token) →
    repeated ``step`` → ``release``. ``start`` raises
    :class:`InsufficientPages` when the paged pool cannot back the request
    right now — release the slot and retry once in-flight requests free
    pages. ``model`` is a ``TransformerLM`` on ``device`` (the card unless
    the CPU is asked for); with ``hold_compute_weights`` the engine serves
    a copy whose matmul weights are already in the compute dtype, the same
    values the per-call casts give."""

    def __init__(
        self,
        cfg,
        model,
        *,
        slots: int = 4,
        max_len: int | None = None,
        prefill_len: int | None = None,
        steps_per_sync: int = 1,
        sentinel=None,
        page_size: int | None = None,
        kv_pages: int = 0,
        prefix_cache: bool = True,
        spec_k: int = 0,
        spec_branches: int = 1,
        prefill_buckets: tuple = (),
        prefill_chunk_tokens: int = 0,
        draft_params=None,
        draft_cfg=None,
        draft_window: int = 16,
        device: torch.device | str = "cuda",
        hold_compute_weights: bool = True,
    ):
        if spec_k or spec_branches != 1:
            raise NotImplementedError(f"speculative decoding (spec_k, spec_branches) {_NOT_PORTED}")
        if draft_params is not None or draft_cfg is not None:
            raise NotImplementedError(f"the learned drafter (draft_params) {_NOT_PORTED}")
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type or (
                self.device.index is not None and model_dev.index != self.device.index):
            raise ValueError(f"the model lives on {model_dev}, the engine on {self.device}")
        max_len = int(max_len or cfg.max_seq_len)
        prefill_len = int(prefill_len or max(1, max_len // 2))
        if max_len > cfg.max_seq_len:
            raise ValueError(f"max_len {max_len} > model max_seq_len {cfg.max_seq_len}")
        if not 1 <= prefill_len <= max_len:
            raise ValueError(f"prefill_len {prefill_len} outside [1, max_len {max_len}]")
        if steps_per_sync < 1:
            raise ValueError(f"steps_per_sync must be >= 1, got {steps_per_sync}")
        if page_size is None:
            page_size = 16 if max_len % 16 == 0 else max_len
        self.cfg = cfg
        self.model = compute_copy(model) if hold_compute_weights else model
        self.slots = int(slots)
        self.max_len = max_len
        self.prefill_len = prefill_len
        self.steps_per_sync = int(steps_per_sync)
        self.page_size = int(page_size)
        self.paged = self.page_size > 0
        # Prefill width buckets (paged only); the largest is prefill_len.
        buckets = {int(b) for b in prefill_buckets} if self.paged else set()
        for b in buckets:
            if not 1 <= b <= prefill_len:
                raise ValueError(f"prefill bucket {b} outside [1, prefill_len {prefill_len}]")
        buckets.add(prefill_len)
        # Chunked prefill (paged only): 0 = auto (chunk = prefill_len),
        # -1 = off (prefill_len stays a hard prompt cap). Buckets wider
        # than the chunk are never used once chunking is on.
        c = int(prefill_chunk_tokens)
        if self.paged and c >= 0:
            if c == 0:
                c = prefill_len
            if not 1 <= c <= prefill_len:
                raise ValueError(f"prefill_chunk_tokens {c} outside [1, prefill_len {prefill_len}]")
            buckets = {b for b in buckets if b <= c}
            buckets.add(c)
        else:
            c = -1
        self.prefill_chunk_tokens = c
        self.prefill_buckets = tuple(sorted(buckets))
        self.sentinel = sentinel
        self.weight_version = 0
        self.serving_variant = ""
        self.tp = 1
        if self.paged:
            self.pool = PagedKVPool(cfg, self.slots, max_len, self.page_size, kv_pages,
                                    device=self.device)
            self.prefix = PrefixCache(self.pool) if prefix_cache else None
        else:
            self.pool = SlotKVPool(cfg, self.slots, max_len, device=self.device)
            self.prefix = None
        n = self.slots
        self.active = np.zeros(n, bool)
        self.lengths = np.zeros(n, np.int32)  # filled cache prefix per slot
        self.cur_tok = np.zeros(n, np.int32)  # last sampled, next to feed
        self.temp = np.zeros(n, np.float32)
        self.top_k = np.zeros(n, np.int32)
        self.top_p = np.zeros(n, np.float32)
        self.seed = np.zeros(n, np.uint32)
        self.made = np.zeros(n, np.int32)  # tokens generated so far
        self.budget = np.ones(n, np.int32)  # max_new_tokens per slot
        self.eos = np.full(n, -1, np.int32)  # -1 = no eos stop
        self.prefilling = np.zeros(n, bool)
        self._pf: dict[int, dict] = {}
        self._pf_queue: deque[int] = deque()
        self.stats = {
            "prefix_tokens_matched": 0,
            "prefix_tokens_total": 0,
            "spec_drafts_accepted": 0,
            "spec_drafts_proposed": 0,
            "spec_drafts_accepted_ngram": 0,
            "spec_drafts_proposed_ngram": 0,
            "spec_drafts_accepted_model": 0,
            "spec_drafts_proposed_model": 0,
            "spec_rounds": 0,
            "spec_rounds_sampled": 0,
            "spec_verifies": 0,
            "plain_rounds": 0,
            "prefill_chunks": 0,
            "prefill_tokens_last_iter": 0,
        }
        self.accept_samples: deque[int] = deque(maxlen=4096)
        self._signatures: set[tuple] = set()
        # Check hook: set to a list, it gets (slot, token index, token, the
        # f32 logits row it was picked from, on the host) for every pick.
        self.logit_trace: list | None = None

    # -- slot lifecycle ---------------------------------------------------

    @property
    def free_slots(self) -> int:
        return self.pool.num_free

    @property
    def active_count(self) -> int:
        return int(self.active.sum())

    @property
    def prefilling_count(self) -> int:
        return int(self.prefilling.sum())

    @property
    def max_prompt_len(self) -> int:
        """Longest admissible prompt: ``prefill_len`` when chunked prefill
        is off, else any prompt that leaves room for one new token."""
        if self.paged and self.prefill_chunk_tokens > 0:
            return self.max_len - 1
        return self.prefill_len

    @property
    def pages_free(self) -> int | None:
        return self.pool.pages_free if self.paged else None

    @property
    def utilization(self) -> float:
        """Page occupancy under paging, slot occupancy otherwise."""
        return self.pool.occupancy

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix.hit_rate if self.prefix is not None else 0.0

    @property
    def spec_accept_rate(self) -> float:
        return 0.0

    def spec_accept_rate_for(self, drafter: str) -> float:
        return 0.0

    @property
    def spec_accept_per_verify(self) -> float:
        return 0.0

    @property
    def kv_dtype(self) -> str:
        """The serving mode's KV label, as the JAX engine reports it:
        ``'bf16'`` names compute-dtype rows (f32 bytes under f32 compute)."""
        return "bf16"

    @property
    def kv_bytes_per_token(self) -> float:
        return self.pool.bytes_per_token

    @property
    def mesh_device_count(self) -> int:
        return 1

    @property
    def hbm_bytes_per_device(self) -> int:
        return int(self.pool.hbm_bytes)

    @property
    def weight_dtype(self) -> str:
        return "native"

    @property
    def draft_weight_dtype(self) -> str:
        return ""

    @property
    def weight_bytes_per_device(self) -> int:
        """Bytes of the weights the engine serves."""
        return int(sum(p.numel() * p.element_size() for p in self.model.parameters()))

    def acquire_slot(self) -> int | None:
        return self.pool.alloc()

    def release(self, slot: int) -> None:
        self.active[slot] = False
        if self.prefilling[slot]:
            self.prefilling[slot] = False
            self._pf.pop(slot, None)
            try:
                self._pf_queue.remove(slot)
            except ValueError:
                pass
        self.pool.free(slot)

    def start(self, slot: int, prompt, *, max_new_tokens: int, temperature: float = 0.0,
              top_k: int = 0, top_p: float = 0.0, seed: int = 0,
              eos_id: int | None = None) -> tuple[int | None, bool]:
        """Prefill ``prompt`` into ``slot`` and pick its first token.

        Returns ``(first_token, finished)``. When the post-adoption tail
        exceeds the chunk width no forward runs here: the slot enters the
        PREFILLING phase, ``(None, False)`` is returned, and the first token
        comes out of a later :meth:`step` as a leading row."""
        prompt = np.asarray(prompt, np.int32).ravel()
        p = int(prompt.size)
        if p < 1:
            raise ValueError("prompt must contain at least one token")
        if p > self.max_prompt_len:
            raise ValueError(
                f"prompt length {p} > engine prefill_len {self.prefill_len}"
                if self.max_prompt_len == self.prefill_len
                else f"prompt length {p} > engine max prompt {self.max_prompt_len}"
            )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if p + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {p} + {max_new_tokens} new > engine max_len {self.max_len}")
        sampled = temperature > 0.0
        sargs = (float(temperature), int(top_k), float(top_p), int(seed) & 0xFFFFFFFF)
        eos = -1 if eos_id is None else int(eos_id)
        if self.paged:
            first = self._start_paged(slot, prompt, p, max_new_tokens, sargs, sampled)
        else:
            padded = np.zeros((1, self.prefill_len), np.int32)
            padded[0, :p] = prompt
            first = self._prefill(slot, padded, p, 0, sampled, sargs)
        self.temp[slot] = temperature
        self.top_k[slot] = top_k
        self.top_p[slot] = top_p
        self.seed[slot] = np.uint32(sargs[3])
        self.budget[slot] = max_new_tokens
        self.eos[slot] = eos
        if first is None:
            self.active[slot] = False
            self.lengths[slot] = 0
            self.made[slot] = 0
            self._poll()
            return None, False
        finished = max_new_tokens == 1 or first == eos
        self.active[slot] = not finished
        self.lengths[slot] = p
        self.cur_tok[slot] = first
        self.made[slot] = 1
        self._poll()
        return first, finished

    def _start_paged(self, slot, prompt, p, max_new, sargs, sampled):
        """Page allocation + prefix adoption + tail prefill for one slot.
        Returns the first token, or None when a chunk plan was scheduled."""
        pool, ps = self.pool, self.page_size
        n_pages = pool.pages_needed(p, max_new)
        # The tail keeps >= 1 real token (the first token comes from p-1).
        cap = (p - 1) // ps
        matched = self.prefix.match(prompt, cap) if self.prefix else []
        # The narrowest bucket holding the post-adoption tail; adoption is
        # clamped per bucket so the tail's write stays below max_len.
        m_pages = 0
        fits = False
        for width in self.prefill_buckets:
            m_pages = min(len(matched), (self.max_len - width) // ps)
            if p - m_pages * ps <= width:
                fits = True
                break
        if not fits:
            return self._start_chunked(slot, prompt, p, max_new, sargs, sampled, matched)
        for pid in matched[m_pages:]:
            pool.decref(pid)
        matched = matched[:m_pages]
        page_ids = self._claim_pages(slot, matched, n_pages, p, max_new, "")
        m0 = len(matched) * ps
        padded = np.zeros((1, width), np.int32)
        padded[0, : p - m0] = prompt[m0:]
        first = self._prefill(slot, padded, p, m0, sampled, sargs)
        if self.prefix is not None:
            self.prefix.record_lookup(m0, p)
            self.prefix.insert(prompt, page_ids)
            self.stats["prefix_tokens_matched"] = self.prefix.tokens_matched
            self.stats["prefix_tokens_total"] = self.prefix.tokens_looked_up
        return first

    def _claim_pages(self, slot, matched, n_pages, p, max_new, how):
        pool = self.pool
        own = pool.alloc_pages(n_pages - len(matched))
        if own is None and self.prefix is not None:
            self.prefix.evict_for(n_pages - len(matched))
            own = pool.alloc_pages(n_pages - len(matched))
        if own is None:
            for pid in matched:
                pool.decref(pid)
            raise InsufficientPages(
                f"need {n_pages - len(matched)} pages, {pool.pages_free} free (slot {slot}, "
                f"prompt {p} + {max_new} new @ page_size {self.page_size}{how})"
            )
        page_ids = matched + own
        pool.bind(slot, page_ids)
        return page_ids

    def _start_chunked(self, slot, prompt, p, max_new, sargs, sampled, matched):
        """Bind every page up front and plan the chunks: full-width
        intermediates, then one suffix-aligned final chunk ending at
        position p-1. Adoption is capped so at least one intermediate chunk
        runs, which keeps the final chunk above the adopted pages."""
        ps, c = self.page_size, self.prefill_chunk_tokens
        n_pages = self.pool.pages_needed(p, max_new)
        a = min(len(matched), max(0, (p - c - 1) // ps))
        for pid in matched[a:]:
            self.pool.decref(pid)
        matched = matched[:a]
        page_ids = self._claim_pages(slot, matched, n_pages, p, max_new, ", chunked")
        m0 = len(matched) * ps
        chunks = []
        m = m0
        while p - m > c:
            chunks.append((m, c, False))
            m += c
        r = p - m  # 1 <= r <= c: the suffix the final chunk must cover
        w = next(b for b in self.prefill_buckets if b >= r)
        chunks.append((p - w, w, True))
        self._pf[slot] = {
            "slot": slot, "prompt": prompt, "p": p, "chunks": chunks, "idx": 0,
            "sampled": sampled, "sargs": sargs, "page_ids": page_ids, "m0": m0,
        }
        self.prefilling[slot] = True
        self._pf_queue.append(slot)
        if self.prefix is not None:
            self.prefix.record_lookup(m0, p)
            self.stats["prefix_tokens_matched"] = self.prefix.tokens_matched
            self.stats["prefix_tokens_total"] = self.prefix.tokens_looked_up
        return None

    def _advance_prefill(self):
        """Spend up to ``prefill_chunk_tokens`` of prefill (always >= 1
        chunk), round-robin across prefilling slots. Returns ``(events,
        spent)``, events ``(slot, first_token, finished)`` for slots whose
        final chunk landed."""
        events = []
        spent = 0
        chunks_run = 0
        budget = self.prefill_chunk_tokens
        while self._pf_queue:
            slot = self._pf_queue[0]
            st = self._pf[slot]
            m, w, final = st["chunks"][st["idx"]]
            if spent and spent + w > budget:
                break
            first = self._run_chunk(st, m, w, final)
            spent += w
            chunks_run += 1
            st["idx"] += 1
            if final:
                self._pf_queue.popleft()
                del self._pf[slot]
                self.prefilling[slot] = False
                prompt, p = st["prompt"], st["p"]
                finished = int(self.budget[slot]) == 1 or first == int(self.eos[slot])
                self.active[slot] = not finished
                self.lengths[slot] = p
                self.cur_tok[slot] = first
                self.made[slot] = 1
                if self.prefix is not None:
                    # Pages become adoptable once every position is filled.
                    self.prefix.insert(prompt, st["page_ids"])
                events.append((slot, first, finished))
            else:
                self._pf_queue.rotate(-1)
        self.stats["prefill_chunks"] += chunks_run
        self.stats["prefill_tokens_last_iter"] = spent
        return events, spent

    def _run_chunk(self, st, m, w, final):
        """One bucket-program call of the chunk plan: ``w`` real tokens at
        offset ``m``. Only the final chunk picks a token."""
        prompt, p = st["prompt"], st["p"]
        toks = np.ascontiguousarray(prompt[m : m + w][None])
        sampled = final and st["sampled"]
        return self._prefill(st["slot"], toks, p if final else None, m, sampled, st["sargs"])

    # -- the programs -----------------------------------------------------

    def _run(self, signature) -> None:
        self._signatures.add(signature)

    @torch.no_grad()
    def _prefill(self, slot, tokens, length, m0, sampled, sargs):
        """Causal forward of ``tokens`` (1, w) at cache offset ``m0`` into
        ``slot``; returns the token picked at position ``length - 1``
        (greedy, or the stream's draw 0 when ``sampled``), or None when
        ``length`` is None (an intermediate chunk)."""
        w = tokens.shape[1]
        self._run(("prefill", bool(sampled), w))
        dev = self.device
        toks = torch.from_numpy(tokens.astype(np.int64)).to(dev)
        offset = torch.full((1,), m0, dtype=torch.int64, device=dev)
        if self.paged:
            ps = self.page_size
            n_pages = -(-(m0 + w) // ps)
            table = torch.from_numpy(self.pool.page_tables[slot, :n_pages].astype(np.int64))
            view = _PagedView(self.pool.layers, table[None].to(dev), offset, ps)
        else:
            rows = torch.full((1,), slot, dtype=torch.int64, device=dev)
            view = _RowView(self.pool.layers, rows, offset, m0 + w)
        logits, _ = self.model(toks, cache=view)
        if length is None:
            return None
        last = logits[0, length - m0 - 1][None]
        if not sampled:
            tok = int(torch.argmax(last, dim=-1).item())
        else:
            temp, top_k, top_p, seed = sargs
            u = stream_uniforms(seed, 0, last.shape[-1])[None]
            tok = int(sample_logits_batched(last, u, [temp], [top_k], [top_p]).item())
        if self.logit_trace is not None:
            self.logit_trace.append((slot, 0, tok, last[0].cpu()))
        return tok

    def step(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One batch round over every slot: ``(tokens (k, slots) int32,
        valid (k, slots) bool, done (slots,) bool)``, ``k`` =
        ``steps_per_sync``. With chunked prefill in flight, the round first
        spends one iteration's prefill budget; a slot whose final chunk
        lands contributes its first token as one extra LEADING row and
        joins the same call's decode round."""
        if not self.active.any() and not self.prefilling.any():
            raise RuntimeError("step() with no active slots")
        pre_events, _ = self._advance_prefill()
        if self.active.any():
            toks, valid, done = self._decode_round()
        else:
            toks = np.zeros((0, self.slots), np.int32)
            valid = np.zeros((0, self.slots), bool)
            done = np.zeros(self.slots, bool)
            self._poll()
        if pre_events:
            row_t = np.zeros((1, self.slots), np.int32)
            row_v = np.zeros((1, self.slots), bool)
            for slot, first, finished in pre_events:
                row_t[0, slot] = first
                row_v[0, slot] = True
                if finished:
                    done[slot] = True
            toks = np.concatenate([row_t, toks])
            valid = np.concatenate([row_v, valid])
        return toks, valid, done

    @torch.no_grad()
    def _decode_round(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        # The sampled variant handles greedy rows too (per-row temperature),
        # so a mixed batch runs it; an all-greedy batch skips the sorts.
        lanes = np.nonzero(self.active)[0]
        n, k = lanes.size, self.steps_per_sync
        any_sampled = bool((self.temp[lanes] > 0.0).any())
        self._run(("step", any_sampled, self.slots, k))
        self.stats["plain_rounds"] += 1
        dev = self.device
        reach = int(self.lengths[lanes].max()) + k  # positions this round can touch
        regs = [lanes, self.lengths[lanes], self.cur_tok[lanes], self.made[lanes],
                self.budget[lanes], self.eos[lanes]]
        if self.paged:
            n_pages = min(-(-reach // self.page_size), self.pool.pages_per_slot)
            regs.append(self.pool.page_tables[lanes, :n_pages].ravel())
        packed = torch.from_numpy(np.concatenate(regs).astype(np.int64)).to(dev)
        rows, lengths, tok, made, budget, eos = packed[: 6 * n].view(6, n)
        if self.paged:
            tables = packed[6 * n:].view(n, n_pages)
        if any_sampled:
            v = self.cfg.vocab_size
            u = np.zeros((k, n, v), np.float32)
            for j, s in enumerate(lanes):
                if self.temp[s] > 0.0:
                    for i in range(k):
                        u[i, j] = stream_uniforms(int(self.seed[s]), int(self.made[s]) + i,
                                                  v).numpy()
            fparams = torch.from_numpy(np.stack([self.temp[lanes], self.top_k[lanes],
                                                 self.top_p[lanes]]).astype(np.float32)).to(dev)
            u = torch.from_numpy(u).to(dev)
        live = torch.ones(n, dtype=torch.bool, device=dev)
        out_t, out_v, traced = [], [], []
        for i in range(k):
            if self.paged:
                view = _PagedView(self.pool.layers, tables, lengths, self.page_size, live)
            else:
                view = _RowView(self.pool.layers, rows, lengths, min(reach, self.max_len))
            logits, _ = self.model(tok[:, None], cache=view)
            logits = logits[:, -1]
            if any_sampled:
                nxt = sample_logits_batched(logits, u[i], fparams[0], fparams[1].long(), fparams[2])
            else:
                nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(live, nxt.to(torch.int64), tok)
            lengths = torch.where(live, lengths + 1, lengths)
            made = torch.where(live, made + 1, made)
            finished = live & ((made >= budget) | (nxt == eos))
            out_t.append(nxt)
            out_v.append(live)
            if self.logit_trace is not None:
                traced.append(logits)
            live = live & ~finished
            tok = nxt
        back = torch.cat([torch.stack(out_t).ravel(), torch.stack(out_v).ravel().long(),
                          live.long(), lengths, tok, made]).cpu().numpy()  # the round's one copy back
        toks = np.zeros((k, self.slots), np.int32)
        valid = np.zeros((k, self.slots), bool)
        toks[:, lanes] = back[: k * n].reshape(k, n)
        valid[:, lanes] = back[k * n: 2 * k * n].reshape(k, n).astype(bool)
        tail = back[2 * k * n:].reshape(4, n)
        for i, lg in enumerate(traced):
            lg = lg.cpu()
            for j, s in enumerate(lanes):
                if valid[i, s]:
                    self.logit_trace.append((int(s), int(self.made[s]) + i, int(toks[i, s]), lg[j]))
        was_active = self.active.copy()
        self.active[lanes] = tail[0].astype(bool)
        self.lengths[lanes] = tail[1]
        self.cur_tok[lanes] = tail[2]
        self.made[lanes] = tail[3]
        self._poll()
        return toks, valid, was_active & ~self.active

    # -- warmup / zero-recompile accounting -------------------------------

    def _poll(self) -> None:
        if self.sentinel is not None:
            self.sentinel.poll(self.compile_count())

    def warmup(self) -> int:
        """Run the full program set on throwaway requests; returns
        :meth:`compile_count`, which must not grow afterwards. Covers the
        greedy and sampled prefill + decode round, every prefill bucket
        width, and (when chunked prefill can trigger) one chunked prompt
        per sampling variant driven to completion."""
        for kwargs in ({"temperature": 0.0}, {"temperature": 1.0, "top_k": 2, "top_p": 0.9}):
            slot = self.acquire_slot()
            if slot is None:
                raise RuntimeError("warmup needs a free slot")
            try:
                _, finished = self.start(slot, [0], max_new_tokens=2, seed=0, **kwargs)
                if not finished:
                    while self.active[slot]:
                        self.step()
                    self.active[slot] = False
            finally:
                self.release(slot)
        # The passes above prefilled through the smallest bucket (p=1); a
        # length-b prompt forces bucket b. Adoption is off here, or the
        # sampled pass would adopt the greedy pass's pages and take a
        # narrower bucket.
        prefix, self.prefix = self.prefix, None
        try:
            for width in self.prefill_buckets[1:]:
                p_warm = min(width, self.max_len - 1)
                for kwargs in ({}, {"temperature": 1.0, "top_k": 2}):
                    slot = self.acquire_slot()
                    try:
                        self.start(slot, [0] * p_warm, max_new_tokens=1, seed=0, **kwargs)
                    finally:
                        self.release(slot)
        finally:
            self.prefix = prefix
        if self.paged and 0 < self.prefill_chunk_tokens < self.max_len - 1:
            p_long = min(self.prefill_chunk_tokens + 1, self.max_len - 1)
            for kwargs in ({}, {"temperature": 1.0, "top_k": 2}):
                slot = self.acquire_slot()
                try:
                    self.start(slot, [0] * p_long, max_new_tokens=1, seed=0, **kwargs)
                    while self.prefilling[slot]:
                        self.step()
                finally:
                    self.release(slot)
        if self.prefix is not None:
            # Warmup's throwaway prompts must not linger as adoptable
            # prefixes (or skew the hit-rate counters).
            self.prefix.clear()
            self.prefix.tokens_matched = 0
            self.prefix.tokens_looked_up = 0
            self.stats["prefix_tokens_matched"] = 0
            self.stats["prefix_tokens_total"] = 0
        n = self.compile_count()
        if self.sentinel is not None:
            self.sentinel.poll(n)
            self.sentinel.mark_warm()
        return n

    def compile_count(self) -> int:
        """Distinct (program, sampling variant, operand shape) signatures
        run so far — stable after :meth:`warmup`."""
        return len(self._signatures) + self.pool.compile_count()

    # -- surfaces of later slices -------------------------------------------

    def check_swap_compatible(self, candidate) -> None:
        raise NotImplementedError(f"weight swap {_NOT_PORTED}")

    stage_weights = adopt_weights = check_swap_compatible

    def export_slot(self, slot: int, **_) -> dict:
        raise NotImplementedError(f"slot export/import (handoff) {_NOT_PORTED}")

    export_slot_meta = import_slot = adopt_imported_slot = validate_handoff_header = export_slot


class ShardedSlotEngine(SlotEngine):
    """The JAX package's tensor-parallel engine: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("ShardedSlotEngine (tp serving) is not ported yet")
