"""
lkpy_tpu_torch: the PyTorch and CUDA port of ``lkpy_tpu``.

It mirrors ``lkpy_tpu``'s layout and names and runs on an NVIDIA GPU; its
hand-written kernels live in ``csrc/`` and build at first use.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.  The port imports
nothing of JAX or of ``lkpy_tpu``.

The first slice is implicit-ALS batch serving:
:func:`lkpy_tpu_torch.batch.device.device_recommend` with
:class:`lkpy_tpu_torch.models.als.ImplicitMFScorer`.
"""

from lkpy_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
