"""Declarative sharding: regex rules over parameter names.

Counterpart of ``distributed_tensorflow_tpu/parallel/rules.py`` for the
tensor-parallel training split (``TP_TRAIN_RULES``). An ordered table of
``(regex, dim)`` pairs is resolved against each state-dict name — the first
``re.search`` hit wins — and says which dimension of the tensor a model
rank slices, or None for a tensor every rank holds whole. Scalars are never
sliced, and a tensor no rule matches is an error rather than a silent
replica.

The Megatron split for ``TpTransformerLM``'s separate q/k/v projections, on
``nn.Linear.weight`` (out, in) — the JAX table's ``P(None, 'model')`` on a
flax kernel (in, out) is this table's out dimension, 0:

  * q, k, v, mlp_in weight and bias: column-parallel, dim 0;
  * proj, mlp_out weight: row-parallel, dim 1;
  * everything else — embeddings, norms, lm_head, and the block-level
    ``proj_bias`` / ``mlp_out_bias`` added after the all-reduce: whole.
"""

from __future__ import annotations

import re

TP_TRAIN_RULES = (
    (r"(?:^|\.)(?:q|k|v|mlp_in)\.(?:weight|bias)$", 0),
    (r"(?:^|\.)(?:proj|mlp_out)\.weight$", 1),
    (r".*", None),
)


def match_partition_rules(rules, shapes: dict) -> dict[str, int | None]:
    """``{name: dim or None}`` for ``shapes`` (``{name: shape}``, e.g. from a
    state dict's tensors' ``.shape``) under ``rules``. Raises ``ValueError``
    for a non-scalar name no rule matches."""
    rules = tuple(rules)
    out = {}
    for name, shape in shapes.items():
        if len(shape) == 0:
            out[name] = None
            continue
        for pattern, dim in rules:
            if re.search(pattern, name):
                out[name] = dim
                break
        else:
            raise ValueError(f"Partition rule not found for param: {name}")
    return out
