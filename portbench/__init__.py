"""The benchmark of ``lkpy_tpu_torch``, the PyTorch and CUDA port: see
``run.py`` and PERF.md."""
