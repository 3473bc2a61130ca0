"""The port's KV pools and prefix cache against the JAX package's.

The bookkeeping is host numpy on both sides, so one scripted sequence of
slot and page operations (allocs, binds, prefix matches and inserts,
evictions under page pressure, frees) runs through both packages' pools
and must leave equal page tables, refcounts, free counts and hit rates
after every operation. The port's pools hold torch tensors in the JAX
layouts (``(slots, kv, max_len, dh)`` and ``(pages, kv, page_size, dh)``,
kv heads unexpanded) with the same byte accounting.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distributed_tensorflow_tpu.serve import kv_pool as JK
from distributed_tensorflow_tpu_torch.models.transformer import TransformerConfig
from distributed_tensorflow_tpu_torch.serve import kv_pool as TK

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

SHAPE = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2, num_layers=2, d_ff=64,
             max_seq_len=48)
TCFG = TransformerConfig(**SHAPE)
JCFG = JaxConfig(compute_dtype=jnp.float32, **SHAPE)


def _state(pool, cache):
    return (pool.page_tables.tolist(), pool.refcount.tolist(), pool.pages_free, pool.num_free,
            round(pool.occupancy, 12), len(cache), cache.hit_rate)


def test_scripted_bookkeeping_matches_jax():
    pools = [(JK.PagedKVPool(JCFG, slots=3, max_len=32, page_size=8, num_pages=10),),
             (TK.PagedKVPool(TCFG, slots=3, max_len=32, page_size=8, num_pages=10),)]
    pools = [(p, mod.PrefixCache(p)) for (p,), mod in zip(pools, (JK, TK))]
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 64, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 64, n).astype(np.int32)])
               for n in (3, 9, 1)] + [rng.integers(1, 64, 20).astype(np.int32)]

    def script(pool, cache):
        seen = []
        slots = {}
        for i, prompt in enumerate(prompts):
            slot = pool.alloc()
            matched = cache.match(prompt, (len(prompt) - 1) // pool.page_size)
            need = pool.pages_needed(len(prompt), 4)
            own = pool.alloc_pages(need - len(matched))
            if own is None:
                cache.evict_for(need - len(matched))
                own = pool.alloc_pages(need - len(matched))
            if own is None:
                for pid in matched:
                    pool.decref(pid)
                pool.free(slot)
                seen.append(("refused", i))
                continue
            pool.bind(slot, matched + own)
            cache.record_lookup(len(matched) * pool.page_size, len(prompt))
            cache.insert(prompt, matched + own)
            slots[i] = slot
            seen.append(_state(pool, cache))
            if i == 1:  # free the first request mid-script
                pool.free(slots.pop(0))
                seen.append(_state(pool, cache))
        for slot in slots.values():
            pool.free(slot)
        seen.append(_state(pool, cache))
        cache.clear()
        seen.append(_state(pool, cache))
        return seen

    (jp, jc), (tp, tc) = pools
    want, got = script(jp, jc), script(tp, tc)
    assert got == want
    assert tp.pages_free == tp.num_pages - 1  # every page back after the last free


def test_pool_layouts_and_bytes_match_jax():
    jp = JK.PagedKVPool(JCFG, slots=2, max_len=32, page_size=8)
    tp = TK.PagedKVPool(TCFG, slots=2, max_len=32, page_size=8)
    assert tp.num_pages == jp.num_pages == 2 * 4 + 1
    assert tuple(tp.layers[0]["k"].shape) == tuple(jp.layers[0]["k"].shape) == (9, 2, 8, 8)
    assert tp.hbm_bytes == jp.hbm_bytes and tp.bytes_per_token == jp.bytes_per_token
    js = JK.SlotKVPool(JCFG, slots=2, max_len=32)
    ts = TK.SlotKVPool(TCFG, slots=2, max_len=32)
    assert tuple(ts.layers[1]["v"].shape) == tuple(js.layers[1]["v"].shape) == (2, 2, 32, 8)
    assert ts.hbm_bytes == js.hbm_bytes and ts.bytes_per_token == js.bytes_per_token


def test_double_free_stale_table_and_trash():
    """tests/test_paged_kv.py's units: a freed row points at the trash
    page, double frees raise, and the trash page is never allocatable."""
    pool = TK.PagedKVPool(TCFG, slots=2, max_len=32, page_size=8)
    slot = pool.alloc()
    pages = pool.alloc_pages(3)
    pool.bind(slot, pages)
    assert list(pool.page_tables[slot][:3]) == pages
    assert pool.page_tables[slot][3] == TK.TRASH_PAGE
    free_before = pool.pages_free
    pool.free(slot)
    assert (pool.page_tables[slot] == TK.TRASH_PAGE).all()
    assert pool.pages_free == free_before + 3
    with pytest.raises(ValueError, match="double free"):
        pool.free(slot)
    with pytest.raises(ValueError, match="double free"):
        pool.decref(pages[0])
    with pytest.raises(ValueError):
        pool.incref(TK.TRASH_PAGE)
    assert TK.TRASH_PAGE not in pool.alloc_pages(pool.pages_free)
    assert pool.alloc_pages(1) is None
    mono = TK.SlotKVPool(TCFG, slots=1, max_len=8)
    s = mono.alloc()
    assert mono.alloc() is None
    mono.free(s)
    with pytest.raises(ValueError, match="double free"):
        mono.free(s)


def test_page_scatter_writes_whole_pages():
    pool = TK.PagedKVPool(TCFG, slots=2, max_len=16, page_size=8)
    rows = [{"k": torch.full((2, 2, 8, 8), float(i + 1)), "v": torch.full((2, 2, 8, 8), -1.0)}
            for i in range(TCFG.num_layers)]
    pool.scatter_pages([3, 1], rows)
    assert (pool.layers[1]["k"][[1, 3]] == 2.0).all() and (pool.layers[0]["v"][3] == -1).all()
    assert not pool.layers[0]["k"][[0, 2, 4]].any()
