"""PyTorch / CUDA port of mqdet_tpu (MQ-Det), for one NVIDIA H100.

The module layout mirrors `mqdet_tpu/`; the JAX package is the reference
that `tests/test_torch_port_*.py` hold this one against. This package
imports torch and never JAX. Its hand-written kernels live in `csrc/` and
are built with nvcc at first use (`ops/kernels.py`).
"""
