"""
lkpy_tpu_torch: the PyTorch and CUDA port of ``lkpy_tpu``.

It mirrors ``lkpy_tpu``'s layout and names and runs on an NVIDIA GPU; its
hand-written kernels live in ``csrc/`` and build at first use.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.  The port imports
nothing of JAX or of ``lkpy_tpu``.

The ported slices are ALS training,
:meth:`lkpy_tpu_torch.models.als.ImplicitMFScorer.train` and
:meth:`lkpy_tpu_torch.models.als.BiasedMFScorer.train` with
:class:`lkpy_tpu_torch.training.TrainingOptions`; batch serving,
:func:`lkpy_tpu_torch.batch.device.device_recommend`; large-catalog
retrieval, :func:`lkpy_tpu_torch.ops.topk.retrieval_topk`; and the bias
model, :mod:`lkpy_tpu_torch.models.bias`.
"""

from lkpy_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
