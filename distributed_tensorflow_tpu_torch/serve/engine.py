"""Continuous-batching decode engine over one model on one device.

Counterpart of ``distributed_tensorflow_tpu/serve/engine.py::SlotEngine``
without weight swap, slot export/import and the sharded engine. The engine
runs one of two KV layouts behind the same slot API:

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
* **speculative verify** (``spec_k > 0``, paged only) — each active slot
  drafts ``spec_k`` tokens (prompt lookup over its own history,
  ``models/decoding.py::propose_ngram_drafts``, or a learned draft model,
  ``build_draft_fn``) and ONE forward of ``[cur_tok, d_0..d_{k-1}]``
  verifies them: greedy lanes emit ``targets[:a+1]`` (``a`` leading drafts
  equal to the target's argmax — token-identical to plain decoding),
  sampled lanes the lossless ``rejection_verify_row``. With
  ``spec_branches > 1`` each slot feeds a ``(branches, spec_k)`` draft TREE
  (branch 0 the linear drafter's, the others n-gram continuations pooled
  over every active slot's history) in one ``1 + branches·spec_k`` wide
  forward under the ancestor ``self_mask``, positions following tree depth;
  the best branch wins (ties to branch 0), sampled lanes take
  ``tree_rejection_verify_row``. A verify forward runs on a gathered copy of
  each lane's pages, then writes the accepted path back at the canonical
  positions (the tree's winning branch compacted behind the current token):
  the block's keys never touch a page another lane reads.

Correctness invariant for slot reuse: a step at length ``len`` writes
position ``len`` BEFORE attending keys ``0..len``, so every key a request
reads was written by that request; freed slots and pages are never zeroed.

Sampling: a sampled pick at a slot's ``made``-th token draws from
``models/decoding.py::stream_uniforms(seed, made)``: the stream is a
function of the request's seed, whatever shares the batch. Greedy rows
take the argmax.

The model may be weight-quantized (``QuantDense`` layers) and the pool may
hold int8 rows with f32 scale planes (``kv_cache_dtype="int8"``);
``hold_compute_weights`` never makes a compute-dtype copy of a quantized
layer.

The engine is single-threaded by contract: one thread owns it and makes
every device call, on the engine's device.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.models.decoding import (
    build_draft_fn,
    compute_copy,
    filter_logits_batched,
    propose_ngram_drafts,
    propose_ngram_tree,
    rejection_verify_row,
    sample_logits_batched,
    stream_uniforms,
    tree_rejection_verify_row,
)
from distributed_tensorflow_tpu_torch.models.transformer import ContiguousKV
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

    def write(self, layer, k, v, k_scale=None, v_scale=None):
        if self._where is None:
            pos = self.lengths[:, None] + torch.arange(k.shape[2], device=k.device)
            page = torch.gather(self.tables, 1, pos // self.page_size)
            if self.live is not None:
                page = torch.where(self.live[:, None], page, TRASH_PAGE)
            self._where = (page, pos % self.page_size)
        page, off = self._where
        buf = self.layers[layer]
        for name, t in (("k", k), ("v", v), ("k_scale", k_scale), ("v_scale", v_scale)):
            if t is not None:  # int8: the codes and their (n, kv, s) row scales
                buf[name][page, :, off] = t.transpose(1, 2).to(buf[name].dtype)

    def read(self, layer):
        n, p = self.tables.shape
        out = []
        for name in ("k", "v", "k_scale", "v_scale"):
            if name not in self.layers[layer]:
                out.append(None)
                continue
            g = self.layers[layer][name][self.tables]  # (n, P, kv, ps[, dh])
            f = torch.empty((n, g.shape[2], p) + g.shape[3:], dtype=torch.float32, device=g.device)
            f.copy_(g.transpose(1, 2))
            out.append(f.view((n, g.shape[2], p * g.shape[3]) + g.shape[4:]))
        return tuple(out)


class _RowView:
    """KV view of ``n`` lanes over the monolithic pool: ``rows`` (n,) slot
    rows, keys read up to ``extent``."""

    def __init__(self, layers, rows, lengths, extent):
        self.layers, self.rows, self.lengths, self.extent = layers, rows, lengths, extent
        self._pos = None  # the written positions, shared by the layers

    def write(self, layer, k, v, k_scale=None, v_scale=None):
        if self._pos is None:
            self._pos = self.lengths[:, None] + torch.arange(k.shape[2], device=k.device)
        pos = self._pos
        buf = self.layers[layer]
        for name, t in (("k", k), ("v", v), ("k_scale", k_scale), ("v_scale", v_scale)):
            if t is not None:
                buf[name][self.rows[:, None], :, pos] = t.transpose(1, 2).to(buf[name].dtype)

    def read(self, layer):
        buf = self.layers[layer]
        cut = lambda name: buf[name][self.rows, :, : self.extent].float() if name in buf else None
        return cut("k"), cut("v"), cut("k_scale"), cut("v_scale")


class _GatheredView(ContiguousKV):
    """A verify round's KV view: each lane's first P pages gathered into
    contiguous rows ``(n, kv, P·ps[, dh])`` (as the JAX programs gather a
    slot's logical cache), written and read there; :meth:`scatter_back`
    copies chosen positions into the pool."""

    def __init__(self, layers, tables, lengths, page_size):
        rows = []
        for layer in layers:
            got = {}
            for name, buf in layer.items():
                g = buf[tables].transpose(1, 2)  # (n, kv, P, ps[, dh])
                got[name] = g.reshape(g.shape[:2] + (-1,) + g.shape[4:])
            rows.append(got)
        super().__init__(rows, lengths)
        self.pool_layers, self.tables, self.page_size = layers, tables, page_size

    def scatter_back(self, src, dst):
        """Pool positions ``dst`` (n, m) of each lane take the gathered rows'
        positions ``src`` (n, m)."""
        lanes = torch.arange(src.shape[0], device=src.device)[:, None]
        page = torch.gather(self.tables, 1, dst // self.page_size)
        off = dst % self.page_size
        for pool, got in zip(self.pool_layers, self.layers):
            for name, buf in pool.items():
                buf[page, :, off] = got[name][lanes, :, src]


class SlotEngine:
    """Fixed-capacity continuous-batching engine over one model.

    ``acquire_slot`` → ``start`` (prefill, returns the first token) →
    repeated ``step`` → ``release``. ``start`` raises
    :class:`InsufficientPages` when the paged pool cannot back the request
    right now — release the slot and retry once in-flight requests free
    pages. ``model`` is a ``TransformerLM`` on ``device`` (the card unless
    the CPU is asked for); with ``hold_compute_weights`` the engine serves
    a copy whose matmul weights are already in the compute dtype, the same
    values the per-call casts give (a quantized layer stays quantized).
    ``draft_params`` is the learned drafter, a ``TransformerLM`` of config
    ``draft_cfg`` on the same device (``models/decoding.py::
    init_draft_params`` or a draft bundle)."""

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
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k and not page_size:
            raise ValueError("spec_k > 0 requires the paged KV layout")
        spec_branches = int(spec_branches)
        if spec_branches < 1:
            raise ValueError(f"spec_branches must be >= 1, got {spec_branches}")
        if spec_branches > 1:
            if not spec_k:
                raise ValueError("spec_branches > 1 requires spec_k > 0")
            if cfg.attention_window is not None:
                # In-block positions are not monotone in write order, which
                # the window's relative-offset mask cannot express.
                raise ValueError("spec_branches > 1 (tree speculation) is incompatible "
                                 "with attention_window")
            if 1 + spec_branches * spec_k > max_len - 1:
                raise ValueError(
                    f"tree verify width 1 + {spec_branches}*{spec_k} exceeds max_len - 1 "
                    f"({max_len - 1}); shrink spec_branches/spec_k")
        self.cfg = cfg
        model = model.with_config(cfg)  # the pool's KV format is the model's
        self.model = compute_copy(model) if hold_compute_weights else model
        self.slots = int(slots)
        self.max_len = max_len
        self.prefill_len = prefill_len
        self.steps_per_sync = int(steps_per_sync)
        self.page_size = int(page_size)
        self.paged = self.page_size > 0
        self.spec_k = int(spec_k)
        self.spec_branches = spec_branches
        # Positions a verify round writes above each slot's length: the whole
        # fed block (the end-of-window fallback guard in _decode_round).
        self._spec_write = 1 + spec_branches * self.spec_k if spec_branches > 1 else self.spec_k + 1
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
        if draft_params is not None:
            if not self.spec_k:
                raise ValueError("draft_params requires spec_k > 0")
            if draft_cfg is None:
                raise ValueError("draft_params requires draft_cfg")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab {draft_cfg.vocab_size} != target vocab "
                                 f"{cfg.vocab_size}")
            # The draft cache holds window + spec_k positions.
            draft_window = min(int(draft_window), draft_cfg.max_seq_len - self.spec_k)
            if draft_window < 1:
                raise ValueError(f"draft max_seq_len {draft_cfg.max_seq_len} too short for "
                                 f"spec_k {self.spec_k}")
            if next(draft_params.parameters()).device.type != self.device.type:
                raise ValueError(f"the drafter lives on {next(draft_params.parameters()).device}, "
                                 f"the engine on {self.device}")
            draft_params = draft_params.with_config(draft_cfg)
            if hold_compute_weights:
                draft_params = compute_copy(draft_params)
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.draft_window = int(draft_window)
        self.drafter = "model" if draft_params is not None else "ngram"
        self._draft = (build_draft_fn(draft_cfg, self.spec_k, self.draft_window)
                       if draft_params is not None else None)
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
        # Prompt + emitted tokens per slot: the drafters' corpus.
        self.history = np.zeros((n, max_len), np.int32)
        self.hist_len = np.zeros(n, np.int32)
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
        self._force_plain = False  # warmup hook: run the non-spec path
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
        prop = self.stats["spec_drafts_proposed"]
        return self.stats["spec_drafts_accepted"] / prop if prop else 0.0

    def spec_accept_rate_for(self, drafter: str) -> float:
        prop = self.stats[f"spec_drafts_proposed_{drafter}"]
        acc = self.stats[f"spec_drafts_accepted_{drafter}"]
        return acc / prop if prop else 0.0

    @property
    def spec_accept_per_verify(self) -> float:
        """Mean accepted drafts per (slot, verify round)."""
        ver = self.stats["spec_verifies"]
        return self.stats["spec_drafts_accepted"] / ver if ver else 0.0

    @property
    def kv_dtype(self) -> str:
        """The serving mode's KV label, as the JAX engine reports it:
        ``'int8'`` for quantize-on-write pages, else ``'bf16'`` (compute-dtype
        rows, f32 bytes under f32 compute)."""
        return "int8" if self.cfg.kv_cache_dtype == "int8" else "bf16"

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
        """``'int8'``/``'int4'`` for a quantized model, else ``'native'``."""
        return self.cfg.weight_dtype or "native"

    @property
    def draft_weight_dtype(self) -> str:
        """The learned drafter's mode (``''`` for the n-gram drafter)."""
        if self.draft_cfg is None:
            return ""
        return self.draft_cfg.weight_dtype or "native"

    @property
    def weight_bytes_per_device(self) -> int:
        """Bytes of the target weights the engine serves (the drafter is
        accounted apart)."""
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
        if self.spec_k:
            self.history[slot, :p] = prompt
            self.hist_len[slot] = p
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
        if self.spec_k:
            self.history[slot, p] = first
            self.hist_len[slot] = p + 1
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
                if self.spec_k:
                    self.history[slot, p] = first
                    self.hist_len[slot] = p + 1
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
        # A verify writes its whole block above each length: a slot within
        # that of max_len takes a plain round instead.
        if (self.spec_k and not self._force_plain
                and bool((self.lengths[lanes] + self._spec_write <= self.max_len).all())):
            return self._spec_round(lanes, any_sampled)
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
        self._record_history(lanes, toks, valid)
        self._poll()
        return toks, valid, was_active & ~self.active

    def _record_history(self, lanes, toks, valid) -> None:
        if self.spec_k:
            for s in lanes:
                emitted = toks[valid[:, s], s]
                n = int(self.hist_len[s])
                self.history[s, n: n + emitted.size] = emitted
                self.hist_len[s] = n + emitted.size

    @torch.no_grad()
    def _spec_round(self, lanes, any_sampled: bool):
        """One verify round over the active ``lanes`` (linear, or a tree with
        ``spec_branches > 1``); the JAX engine's ``spec_fn``/``tree_fn`` and
        their budget / eos truncation."""
        n, D, B = lanes.size, self.spec_k, self.spec_branches
        tree = B > 1
        self._run(("tree" if tree else "spec", any_sampled, self.slots, D))
        S = D + 1
        if tree:
            drafts = self._propose_tree_drafts()[lanes]  # (n, B, D)
            fed = np.concatenate([self.cur_tok[lanes, None], drafts.reshape(n, B * D)], 1)
        else:
            drafts = self._propose_drafts()[lanes]  # (n, D)
            fed = np.concatenate([self.cur_tok[lanes, None], drafts], 1)
        dev, ps, w = self.device, self.page_size, fed.shape[1]
        n_pages = min(-(-(int(self.lengths[lanes].max()) + w) // ps), self.pool.pages_per_slot)
        lengths = torch.from_numpy(self.lengths[lanes].astype(np.int64)).to(dev)
        tables = torch.from_numpy(self.pool.page_tables[lanes, :n_pages].astype(np.int64)).to(dev)
        view = _GatheredView(self.pool.layers, tables, lengths, ps)
        x = torch.from_numpy(fed.astype(np.int64)).to(dev)
        if tree:
            # Node (b, j) is fed at 1 + b·D + j; its position is length + 1 + j.
            depth = np.concatenate([[0], 1 + np.tile(np.arange(D), B)])
            anc = np.zeros((w, w), bool)
            anc[:, 0] = True
            for b in range(B):
                for j in range(D):
                    r = 1 + b * D + j
                    anc[r, 1 + b * D: r + 1] = True
            logits, _ = self.model(x, cache=view, self_mask=torch.from_numpy(anc).to(dev),
                                   positions=lengths[:, None] + torch.from_numpy(depth).to(dev))
        else:
            logits, _ = self.model(x, cache=view)
        targets = torch.argmax(logits, dim=-1).cpu().numpy()  # (n, w)
        if tree:
            par = np.array([[0 if j == 0 else 1 + b * D + j - 1 for j in range(D)]
                            for b in range(B)])
            lead = np.cumprod(drafts == targets[:, par], axis=2).sum(2)  # (n, B)
            bsel = lead.argmax(1)  # first max: ties to branch 0
            a = lead[np.arange(n), bsel]
            rows = np.concatenate([np.zeros((n, 1), np.int64),
                                   1 + bsel[:, None] * D + np.arange(D)], 1)  # (n, S)
        else:
            a = np.cumprod(drafts == targets[:, :D], axis=1).sum(1)
            bsel = np.zeros(n, np.int64)
            rows = np.tile(np.arange(S), (n, 1))
        E = np.take_along_axis(targets, rows, 1)
        sampled = np.nonzero(self.temp[lanes] > 0.0)[0]
        if sampled.size:
            sl = lanes[sampled]
            filt = filter_logits_batched(
                logits[torch.from_numpy(sampled).to(dev)].reshape(-1, logits.shape[-1]),
                np.repeat(self.temp[sl], w), np.repeat(self.top_k[sl], w),
                np.repeat(self.top_p[sl], w)).view(sampled.size, w, -1).cpu()
            for i, j in enumerate(sampled):
                seed, made = int(self.seed[lanes[j]]), int(self.made[lanes[j]])
                if tree:
                    e, a[j], bsel[j] = tree_rejection_verify_row(filt[i], drafts[j], seed, made)
                    rows[j] = np.concatenate([[0], 1 + bsel[j] * D + np.arange(D)])
                else:
                    e, a[j] = rejection_verify_row(filt[i], drafts[j], seed, made)
                E[j] = e.numpy()
        budget, made, eos = self.budget[lanes], self.made[lanes], self.eos[lanes]
        n1 = np.minimum(a + 1, budget - made)
        idx = np.arange(S)[None, :]
        eos_in = (E == eos[:, None]) & (idx < n1[:, None])
        any_eos = eos_in.any(1)
        n_final = np.where(any_eos, eos_in.argmax(1) + 1, n1)
        # Keep the accepted path: position length + j takes the block's row
        # rows[j] (the winning branch moves up behind the current token).
        src = lengths[:, None] + torch.from_numpy(rows).to(dev)
        view.scatter_back(src, lengths[:, None] + torch.arange(S, device=dev))
        if self.logit_trace is not None:
            lg = logits.cpu()
            for j, s in enumerate(lanes):
                for i in range(int(n_final[j])):
                    self.logit_trace.append((int(s), int(made[j]) + i, int(E[j, i]),
                                             lg[j, rows[j, i]]))
        toks = np.zeros((S, self.slots), np.int32)
        valid = np.zeros((S, self.slots), bool)
        toks[:, lanes] = E.T
        valid[:, lanes] = (idx < n_final[:, None]).T
        accepted = np.minimum(a, n_final - 1)
        was_active = self.active.copy()
        self.lengths[lanes] += n_final.astype(np.int32)
        self.made[lanes] += n_final.astype(np.int32)
        self.cur_tok[lanes] = E[np.arange(n), n_final - 1]
        self.active[lanes] = ~((self.made[lanes] >= budget) | any_eos)
        proposed = n * D  # the path budget in both modes: rates stay comparable
        self.accept_samples.extend(int(x) for x in accepted)
        self.stats["spec_rounds"] += 1
        self.stats["spec_verifies"] += n
        self.stats["spec_rounds_sampled"] += int(any_sampled)
        for suffix in ("", f"_{self.drafter}"):
            self.stats[f"spec_drafts_proposed{suffix}"] += proposed
            self.stats[f"spec_drafts_accepted{suffix}"] += int(accepted.sum())
        self._record_history(lanes, toks, valid)
        self._poll()
        return toks, valid, was_active & ~self.active

    def _propose_drafts(self) -> np.ndarray:
        """(slots, spec_k) drafts for the active lanes: the learned drafter
        over every active lane at once when one is loaded (the current token
        is the history's last, so its first output follows it), else prompt
        lookup over each slot's history."""
        drafts = np.zeros((self.slots, self.spec_k), np.int32)
        lanes = np.nonzero(self.active)[0]
        if self._draft is not None:
            self._run(("draft", self.slots, self.draft_window))
            W = self.draft_window
            toks = np.zeros((lanes.size, W), np.int32)
            lens = np.ones(lanes.size, np.int32)
            pos0 = np.zeros(lanes.size, np.int32)
            for i, s in enumerate(lanes):
                n = int(self.hist_len[s])
                m = min(n, W)
                toks[i, :m] = self.history[s, n - m: n]
                lens[i] = max(m, 1)
                pos0[i] = n - m  # the absolute position of toks[i, 0]
            drafts[lanes] = self._draft(self.draft_params, toks, lens, pos0).cpu().numpy()
            return drafts
        for s in lanes:
            drafts[s] = propose_ngram_drafts(self.history[s, : int(self.hist_len[s])], self.spec_k)
        return drafts

    def _propose_tree_drafts(self) -> np.ndarray:
        """(slots, spec_branches, spec_k): branch 0 :meth:`_propose_drafts`'s
        row, the others ``propose_ngram_tree`` over the slot's history and
        every other active slot's."""
        B, D = self.spec_branches, self.spec_k
        tree = np.zeros((self.slots, B, D), np.int32)
        tree[:, 0, :] = self._propose_drafts()
        act = np.nonzero(self.active)[0]
        hists = {s: self.history[s, : int(self.hist_len[s])] for s in act}
        for s in act:
            alt = propose_ngram_tree(hists[s], D, B,
                                     extra_histories=[hists[o] for o in act if o != s])
            tree[s, 1:, :] = alt[1:]
        return tree

    # -- warmup / zero-recompile accounting -------------------------------

    def _poll(self) -> None:
        if self.sentinel is not None:
            self.sentinel.poll(self.compile_count())

    def warmup(self) -> int:
        """Run the full program set on throwaway requests; returns
        :meth:`compile_count`, which must not grow afterwards. Covers the
        greedy and sampled prefill + decode round (the plain rounds forced
        when speculation is on: they serve the end-of-window fallback), both
        verify variants (and the learned drafter), every prefill bucket
        width, and (when chunked prefill can trigger) one chunked prompt
        per sampling variant driven to completion."""
        passes: list[dict] = [{"temperature": 0.0, "_plain": True}]
        if self.spec_k:
            passes.append({"temperature": 0.0})
            passes.append({"temperature": 1.0, "top_k": 2, "top_p": 0.9, "_plain": True})
        passes.append({"temperature": 1.0, "top_k": 2, "top_p": 0.9})
        for kwargs in passes:
            force = kwargs.pop("_plain", False)
            slot = self.acquire_slot()
            if slot is None:
                raise RuntimeError("warmup needs a free slot")
            self._force_plain = force
            try:
                _, finished = self.start(slot, [0], max_new_tokens=2, seed=0, **kwargs)
                if not finished:
                    while self.active[slot]:
                        self.step()
                    self.active[slot] = False
            finally:
                self._force_plain = False
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
