"""
lkpy_tpu_torch: the PyTorch and CUDA port of ``lkpy_tpu``.

It mirrors ``lkpy_tpu``'s layout and names and runs on an NVIDIA GPU; its
hand-written kernels live in ``csrc/`` and build at first use.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.  The port imports
nothing of JAX or of ``lkpy_tpu``.

A user's path, as in the JAX package::

    pipe = topn_pipeline(ImplicitMFScorer(features=64), n=10)
    pipe.train(dataset, TrainingOptions(rng=42))  # on the card
    recs = lkpy_tpu_torch.batch.recommend(pipe, users, n=10)

with :class:`lkpy_tpu_torch.models.als.ImplicitMFScorer`,
:class:`lkpy_tpu_torch.training.TrainingOptions` (``device="cpu"`` trains
on the CPU) and the per-query :func:`recommend`, :func:`score` and
:func:`predict` here.  Ported beside it: batch serving
(:func:`lkpy_tpu_torch.batch.device.device_recommend`), large-catalog
retrieval (:func:`lkpy_tpu_torch.ops.topk.retrieval_topk`), the explicit
family and the bias model.
"""

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data import Dataset, DatasetBuilder, ItemList, ItemListCollection, RecQuery, Vocabulary
from lkpy_tpu_torch.operations import predict, recommend, score
from lkpy_tpu_torch.pipeline import (
    Component,
    Pipeline,
    PipelineBuilder,
    RecPipelineBuilder,
    predict_pipeline,
    topn_pipeline,
)

__all__ = [
    "Component",
    "Dataset",
    "DatasetBuilder",
    "ItemList",
    "ItemListCollection",
    "Pipeline",
    "PipelineBuilder",
    "RecPipelineBuilder",
    "RecQuery",
    "Vocabulary",
    "predict",
    "predict_pipeline",
    "recommend",
    "resolve_device",
    "score",
    "topn_pipeline",
]
