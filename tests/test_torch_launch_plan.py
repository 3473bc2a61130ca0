"""The flash wrappers' launch plans, on the CPU.

A kernel launch goes through a plan cached per call signature
(``ops.attention._Plan``): the source, the (b, h, s) strides array, the
constant arguments and, for packed qkv, the byte offsets of q, k and v
inside qkv, so that a call builds no head views. Building a plan needs no
card. Checked here: the plan's offsets and strides are those of the views
the wrappers used to build (``_packed_heads``, ``_heads``, segment row
slices) for packed qkv with GQA at head_dim 32, 80 (padded to 128), 128
and 320 (padded to 384), forward and backward, and for BHSD and BSHD
operands; the one-copy padding of packed qkv equals ``pad_head_dim`` on
each head view; the cache stays bounded and keys on dtype and shape.
"""

import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import attention as TA

pytestmark = pytest.mark.torch_port


def _operand_checks(plan, views):
    """Each view's (b, h, s) strides are the plan's, in order."""
    got = [plan.stride_values[3 * i:3 * i + 3] for i in range(len(views))]
    assert got == [tuple(v.stride()[:3]) for v in views]
    assert list(plan.strides) == list(plan.stride_values)


@pytest.mark.parametrize("layout,d", [("packed", 32), ("packed", 80), ("packed", 128),
                                      ("packed", 320), ("bhsd", 64), ("bshd", 128)])
def test_plan_offsets_and_strides_equal_the_views(layout, d):
    b, s, h, kv = 2, 48, 8, 2
    dtype = torch.bfloat16
    dp = TA._instance_dim(d)
    if layout == "packed":
        qkv = torch.randn(b, s, (h + 2 * kv) * d).to(dtype)
        if dp != d:  # the one-copy pad equals pad_head_dim on each head view
            padded = TA._pad_packed(qkv, h + 2 * kv, d, dp)
            for got, view in zip(TA._packed_heads(padded, h, kv, dp),
                                 TA._packed_heads(qkv, h, kv, d)):
                assert torch.equal(got, TA.pad_head_dim(view, dp))
            assert torch.equal(TA._unpad_packed(padded, h + 2 * kv, d, dp), qkv)
            qkv = padded
        out = torch.empty(b, s, h * dp, dtype=dtype)
        for direction in ("fwd", "bwd"):
            source = (TA.forward_kernel(dtype, dp) if direction == "fwd"
                      else TA.backward_kernel(dtype, dp, True))
            plan = TA._qkv_plan(direction, source, dtype, b, s, h, kv, dp, True, None, 0.1,
                                None, None if dp == d else (d, dp))
            heads = TA._packed_heads(qkv, h, kv, dp)
            views = [*heads, TA._heads(out, dp)]
            if direction == "bwd":  # out, dO, then dq, dk, dv inside dqkv
                views += [TA._heads(out, dp), *TA._packed_heads(torch.empty_like(qkv), h, kv,
                                                                dp)]
            _operand_checks(plan, views)
            elt = qkv.element_size()
            assert [v.data_ptr() - qkv.data_ptr() for v in heads] == list(plan.offsets)
            assert plan.offsets == TA._packed_offsets(h, kv, dp, elt)
            assert plan.args[1:7] == (b, h, kv, s, s, dp) and plan.args[7] == 1
            assert plan.pad == (None if dp == d else (d, dp))
            # per-batch rope tables are read at the instance's width, padded
            # as pad_rope_tables pads them; one shared row table has stride 0
            cos = torch.rand(b, s, d // 2)
            cos_p, _ = TA.pad_rope_tables(cos, cos, dp)
            for tables, want in ((cos_p, TA._table_stride(cos_p)), (cos_p[:1], 0)):
                rope_plan = TA._qkv_plan(direction, source, dtype, b, s, h, kv, dp, True, None,
                                         0.1, tables.shape[0])
                assert rope_plan.args[11] == want
                if source == "flash_fwd_sm90":  # k rotated once a call, into a scratch
                    assert rope_plan.scratch == (((b, kv, s, dp), dtype),)
        return
    q, k, v, o = (torch.randn(b, s, n, d).to(dtype) for n in (h, kv, kv, h))
    if layout == "bshd":  # the head-transposed views of the activation layout
        q, k, v, o = (t.transpose(1, 2) for t in (q, k, v, o))
    else:
        q, k, v, o = (t.transpose(1, 2).contiguous() for t in (q, k, v, o))
    source = TA.forward_kernel(dtype, dp)
    plan = TA._view_plan(source, q, k, (q, k, v, o), True, None, 0, 0.1, None)
    _operand_checks(plan, (q, k, v, o))
    # A q segment's row slices start at their row offset and keep the full
    # view's strides: the segments' plans differ in the q rows' position
    # (q_pos_offset) alone.
    seg = s // 3
    for a in range(0, s, seg):
        rows = slice(a, a + seg)
        qs, os_ = q[:, :, rows], o[:, :, rows]
        assert qs.data_ptr() - q.data_ptr() == a * q.stride(2) * q.element_size()
        seg_plan = TA._view_plan(source, qs, k, (qs, k, v, os_), True, None, a, 0.1, None)
        _operand_checks(seg_plan, (qs, k, v, os_))
        assert seg_plan.stride_values == plan.stride_values
        assert seg_plan.args[1:11] == (b, h, kv, seg, s, d, 1, 1, 0, a)


def test_plan_cache_stays_bounded(monkeypatch):
    monkeypatch.setattr(TA, "_PLANS", {})
    monkeypatch.setattr(TA, "PLAN_CACHE_SIZE", 8)
    first = TA._cached_plan(("k", 0), lambda: TA._Plan("flash_fwd", [1, 2, 3], (0,)))
    for i in range(1, 40):
        TA._cached_plan(("k", i), lambda: TA._Plan("flash_fwd", [1, 2, 3], (i,)))
        assert len(TA._PLANS) <= 8
    assert ("k", 0) not in TA._PLANS and ("k", 39) in TA._PLANS  # the oldest went first
    again = TA._cached_plan(("k", 0), lambda: TA._Plan("flash_fwd", [1, 2, 3], (0,)))
    assert again is not first and len(TA._PLANS) == 8


def test_plan_cache_keys_on_dtype_and_shape(monkeypatch):
    """Packed calls that differ in dtype or shape get their own plans; equal
    signatures share one, and a swapped source picker makes a new one. The
    key holds the shape, dtype and card of every operand the checks read."""
    monkeypatch.setattr(TA, "_PLANS", {})
    built = []

    def plan_of(qkv, dtype):
        key = TA._qkv_key("fwd", qkv, 4, 2, True, None, None)
        source = key[0]
        b, s, width = qkv.shape
        d = width // 8
        return TA._cached_plan(key, lambda: built.append(key) or TA._qkv_plan(
            "fwd", source, dtype, b, s, 4, 2, d, True, None, None, None))

    bf = torch.zeros(2, 16, 8 * 64, dtype=torch.bfloat16)
    f32 = torch.zeros(2, 16, 8 * 64)
    longer = torch.zeros(2, 32, 8 * 64, dtype=torch.bfloat16)
    p_bf, p_f32, p_long = plan_of(bf, torch.bfloat16), plan_of(f32, torch.float32), \
        plan_of(longer, torch.bfloat16)
    assert len({id(p_bf), id(p_f32), id(p_long)}) == 3 and len(built) == 3
    assert (p_bf.source, p_f32.source) == ("flash_fwd_sm90", "flash_fwd")
    assert p_bf.offsets == (0, 4 * 64 * 2, 6 * 64 * 2) and p_f32.offsets == (0, 4 * 64 * 4,
                                                                               6 * 64 * 4)
    assert p_long.args[4] == 32 and p_bf.args[4] == 16
    assert plan_of(torch.ones_like(bf), torch.bfloat16) is p_bf and len(built) == 3
    g = torch.zeros(2, 16, 4 * 64, dtype=torch.bfloat16)
    lse = torch.zeros(2, 4, 16)
    bwd = TA._qkv_key("bwd", bf, 4, 2, True, None, None, g, lse, g)
    assert bwd[0] == "flash_bwd_sm90"
    assert bwd != TA._qkv_key("fwd", bf, 4, 2, True, None, None)
    assert bwd != TA._qkv_key("bwd", bf, 4, 2, True, None, None, g, lse.double(), g)
    monkeypatch.setattr(TA, "forward_kernel", lambda *a: "flash_fwd")
    assert plan_of(bf, torch.bfloat16) is not p_bf and len(built) == 4
