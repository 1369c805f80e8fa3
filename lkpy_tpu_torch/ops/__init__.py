"""
Kernels and batched array operations of the port (port of ``lkpy_tpu.ops``).

Each hand-written kernel lives in ``csrc/`` and is built at first use by
:mod:`lkpy_tpu_torch.ops._build`; its wrapper module holds the plain
PyTorch version beside it and counts the kernel's launches.
"""
