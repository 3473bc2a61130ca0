"""Kernel probes: counterparts of the JAX package's ``tools/pipeline_probe.py``
(K9) and ``tools/bshd_probe.py`` (K10). Each is a function with a kernel
for CUDA tensors and a plain version for CPU ones, and a ``main()`` that
measures it on the card:

    python -m distributed_tensorflow_tpu_torch.tools.pipeline_probe
    python -m distributed_tensorflow_tpu_torch.tools.bshd_probe
"""
