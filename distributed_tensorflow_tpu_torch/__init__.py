"""distributed_tensorflow_tpu_torch — the PyTorch/CUDA port of
``distributed_tensorflow_tpu``.

The JAX package beside it stays the reference: every module here keeps the
name of its JAX counterpart (``ops/attention.py``, ``models/transformer.py``,
...) so a reader finds each pair, and the tests hold the two against each
other on the CPU. Plain tensor code is PyTorch; each Pallas kernel on the
port's path is a CUDA C++ kernel for Hopper (``sm_90a``) under ``csrc/``,
built with ``nvcc`` at first use (``ops/_build.py``).

This package imports ``torch`` and numpy only — never JAX, and nothing of
``distributed_tensorflow_tpu``.
"""

__version__ = "0.1.0"
