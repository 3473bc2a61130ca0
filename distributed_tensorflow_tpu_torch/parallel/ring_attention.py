"""Ring attention: exact attention over a sequence split across a process
group.

Counterpart of ``distributed_tensorflow_tpu/parallel/ring_attention.py``.
Each rank of ``group`` holds a contiguous S/P slice of q, k and v (rank i
of the group: global positions [i·S_local, (i+1)·S_local)). The key/value
shards travel round the group by point-to-point exchanges while each rank
folds the visiting shard into its own online-softmax carry
(``ops/attention.py``'s block update), so memory stays O(S/P) and the result
is the softmax over the whole sequence.

  * Full ring: the shards move one hop "left" (rank i sends to i−1 and
    receives from i+1), so after t hops a rank holds shard (i + t) mod P;
    P block updates, P − 1 exchanges (the JAX scan's last permute only
    brings the shards home, and its result is discarded).
  * Windowed ring (``window``, causal only): the shards move the other way,
    so hop t brings shard i − t, and the ring stops after
    ``min(P, ceil((window − 1)/S_local) + 1)`` hops (:func:`ring_hops`):
    O(window) traffic and work per rank instead of O(S).

A hop whose block no query of this rank can see (a shard after this one
under causal masking, or one that wrapped past shard 0) skips its block
update, which leaves the carry exactly as the masked update would; the
exchange still runs on every rank, in both directions (a skipped hop
passes a zero gradient back, :class:`_Keep`), so every send meets its
receive. The
exchange is :class:`_RingShift`, whose backward sends the gradient the
opposite way round; each block update recomputes its block in the
backward. These are stock torch ops and point-to-point transfers: the JAX
ring runs in XLA with no Pallas kernel, and no flash kernel runs here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.ops import attention as A


def exchange(x: torch.Tensor, send_to: int, recv_from: int, group) -> torch.Tensor:
    """Send ``x`` to global rank ``send_to`` and return what ``recv_from``
    sends, posted together so that no pair of ranks waits on each other."""
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), send_to, group),
           dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One hop of the ring: forward sends to ``send_to`` and receives from
    ``recv_from``; backward sends the gradient back to ``recv_from`` and
    receives the one ``send_to`` computed. Written out rather than left to
    autograd through a collective, whose backward would not be this
    exchange."""

    @staticmethod
    def forward(ctx, x, send_to, recv_from, group):
        ctx.peers = (send_to, recv_from, group)
        return exchange(x, send_to, recv_from, group)

    @staticmethod
    def backward(ctx, g):
        send_to, recv_from, group = ctx.peers
        return exchange(g, recv_from, send_to, group), None, None, None


class _Keep(torch.autograd.Function):
    """A skipped hop: the carry unchanged, with the hop's k/v buffer as an
    input that takes a zero gradient. Without it a rank whose last hop is
    masked would not run that hop's exchange backward while its neighbour,
    for which the hop is visible, waits in it."""

    @staticmethod
    def forward(ctx, acc, m, l, kv):
        ctx.mark_non_differentiable(m)
        return acc.view_as(acc), m.view_as(m), l.view_as(l)

    @staticmethod
    def backward(ctx, g_acc, _g_m, g_l):
        return g_acc, None, g_l, None


def ring_shift(x: torch.Tensor, send_to: int, recv_from: int, group) -> torch.Tensor:
    """``x`` from global rank ``recv_from`` in exchange for ours to
    ``send_to``, differentiable (:class:`_RingShift`)."""
    return _RingShift.apply(x, send_to, recv_from, group)


def group_layout(group) -> tuple[int, int, list[int]]:
    """(size, this rank's index, the group's global ranks in order) of
    ``group``; None is a group of this rank alone."""
    if group is None:
        return 1, 0, [0]
    size = dist.get_world_size(group)
    return (size, dist.get_group_rank(group, dist.get_rank()),
            [dist.get_global_rank(group, i) for i in range(size)])


def ring_hops(size: int, s_local: int, window: int | None) -> int:
    """The hops the ring runs over ``size`` shards of ``s_local`` positions:
    all of them, or under ``window`` the shards the window reaches back to
    (the JAX ring's scan length)."""
    if window is None:
        return size
    back = 0 if window == 1 else -(-(window - 1) // s_local)
    return min(size, back + 1)


def ring_attention(q, k, v, group=None, causal: bool = False, scale: float | None = None,
                   window: int | None = None):
    """Exact attention over a sequence split across ``group`` (None: this
    rank holds all of it, one hop). ``q``/``k``/``v`` are this rank's shards
    (B, H, S_local, D); returns its (B, H, S_local, D) output in q's dtype.
    ``window`` (requires ``causal``) is the Mistral sliding window, and
    truncates the ring (module docstring)."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    size, idx, ranks = group_layout(group)
    s_local = q.shape[2]
    s = A._scale(q.shape[-1], scale)
    n_hops = ring_hops(size, s_local, window)
    if window is None:
        # After t hops this rank holds shard (idx + t) mod P.
        send_to, recv_from = ranks[(idx - 1) % size], ranks[(idx + 1) % size]
        src_of = lambda t: (idx + t) % size  # noqa: E731
    else:
        # Hop t brings shard idx − t: the window only looks back.
        send_to, recv_from = ranks[(idx + 1) % size], ranks[(idx - 1) % size]
        src_of = lambda t: (idx - t) % size  # noqa: E731
    carry = A.init_carry(q, v.shape[-1])
    kv = torch.stack([k, v])  # one buffer a hop
    for t in range(n_hops):
        # A later shard (causal), one past the window, or under the window
        # one that wrapped past shard 0: nothing this rank's queries see.
        q_lo, k_lo = idx * s_local, src_of(t) * s_local
        if not A.block_visible(q_lo, s_local, k_lo, s_local, causal, window):
            carry = _Keep.apply(*carry, kv) if kv.requires_grad else carry
        else:
            mask = A.position_mask(q_lo, s_local, k_lo, s_local, causal, window, q.device)
            carry = A.online_block_update(carry, q, kv[0], kv[1], mask, s)
        if t < n_hops - 1:
            kv = ring_shift(kv, send_to, recv_from, group)
    return A.finalize(carry[0], carry[2], q.dtype)
