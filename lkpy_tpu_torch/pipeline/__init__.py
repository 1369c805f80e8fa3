"""
Pipeline abstraction: DAGs of recommendation components (port of
``lkpy_tpu.pipeline``; reference: src/lenskit/pipeline/__init__.py).

The profiler (:mod:`~lkpy_tpu_torch.pipeline.profiling`) and the
spec-file loader of ``pipelines/*.toml``
(:mod:`~lkpy_tpu_torch.pipeline.specfile`, imported on its own) are
ported; the JAX package's pipeline diagram and cache are not yet.
"""

from lkpy_tpu_torch.pipeline.builder import PipelineBuilder
from lkpy_tpu_torch.pipeline.common import RecPipelineBuilder, predict_pipeline, topn_pipeline
from lkpy_tpu_torch.pipeline.components import Component, component_inputs
from lkpy_tpu_torch.pipeline.config import PipelineConfig, hash_config
from lkpy_tpu_torch.pipeline.nodes import ComponentNode, FallbackNode, InputNode, LiteralNode, Node
from lkpy_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
from lkpy_tpu_torch.pipeline.profiling import PipelineProfiler, summarize_profile

__all__ = [
    "Component",
    "ComponentNode",
    "FallbackNode",
    "InputNode",
    "LiteralNode",
    "Node",
    "Pipeline",
    "PipelineBuilder",
    "PipelineConfig",
    "PipelineProfiler",
    "PipelineState",
    "RecPipelineBuilder",
    "component_inputs",
    "hash_config",
    "predict_pipeline",
    "summarize_profile",
    "topn_pipeline",
]
