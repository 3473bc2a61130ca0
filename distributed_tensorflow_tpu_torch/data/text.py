"""Byte-level text dataset for LM training (numpy only).

This package's own copy of ``distributed_tensorflow_tpu/data/text.py``: any
file is a token stream at vocab 256 (bytes), sampled as random fixed-size
windows for training, with a held-out tail that training never reads and
evaluation sweeps in sequential windows.
"""

from __future__ import annotations

import numpy as np


def load_byte_tokens(path: str) -> np.ndarray:
    """The whole file as a uint8 token stream (vocab 256)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data:
        raise ValueError(f"empty text file: {path}")
    return np.frombuffer(data, dtype=np.uint8)


def encode_text(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8)


def decode_tokens(ids) -> str:
    return bytes(int(t) & 0xFF for t in np.asarray(ids).reshape(-1)).decode(
        "utf-8", errors="replace"
    )


class ByteTextDataset:
    """Random-window training batches over a byte stream whose tail
    (``holdout_fraction`` of it, ``eval_tokens``) is reserved for
    evaluation (:meth:`eval_batches`)."""

    def __init__(self, tokens: np.ndarray, seq_len: int, holdout_fraction: float = 0.05,
                 seed: int = 0):
        tokens = np.asarray(tokens, dtype=np.uint8)
        if not 0 <= holdout_fraction < 1:
            raise ValueError(f"holdout_fraction {holdout_fraction} outside [0, 1)")
        split = int(len(tokens) * (1 - holdout_fraction))
        if split < seq_len + 1:
            raise ValueError(
                f"text too short: train split {split} tokens < seq_len+1 ({seq_len + 1})"
            )
        self.seq_len = seq_len
        self.train_tokens = tokens[:split]
        self.eval_tokens = tokens[split:]
        self._seed = seed

    def train_batch(self, batch_size: int, step: int = 0) -> np.ndarray:
        """(batch, seq_len) int32 random windows from the train split, a pure
        function of ``(seed, step)`` — the JAX package's exact windows."""
        rng = np.random.default_rng((self._seed, step))
        hi = len(self.train_tokens) - self.seq_len
        starts = rng.integers(0, hi + 1, batch_size)
        return np.stack(
            [self.train_tokens[s : s + self.seq_len] for s in starts]
        ).astype(np.int32)

    def eval_batches(self, batch_size: int):
        """Non-overlapping sequential (batch, seq_len) int32 windows over
        ``eval_tokens``, covering every full window: full batches first,
        then one smaller batch for the remainder. Yields nothing only if the
        holdout has no full window."""
        n_windows = len(self.eval_tokens) // self.seq_len
        windows = self.eval_tokens[: n_windows * self.seq_len].reshape(n_windows, self.seq_len)
        for lo in range(0, n_windows, batch_size):
            yield windows[lo : lo + batch_size].astype(np.int32)
