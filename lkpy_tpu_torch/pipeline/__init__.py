"""
Pipeline abstraction: DAGs of recommendation components (port of
``lkpy_tpu.pipeline``; reference: src/lenskit/pipeline/__init__.py).

With the profiler (:mod:`~lkpy_tpu_torch.pipeline.profiling`), the
Mermaid diagram (:func:`pipeline_diagram`), the component cache
(:class:`PipelineCache`) and the spec-file loader of ``pipelines/*.toml``
(:mod:`~lkpy_tpu_torch.pipeline.specfile`, imported on its own).
"""

from lkpy_tpu_torch.pipeline.builder import PipelineBuilder
from lkpy_tpu_torch.pipeline.cache import PipelineCache
from lkpy_tpu_torch.pipeline.common import RecPipelineBuilder, predict_pipeline, topn_pipeline
from lkpy_tpu_torch.pipeline.components import Component, component_inputs, component_return_type
from lkpy_tpu_torch.pipeline.config import PipelineConfig, hash_config
from lkpy_tpu_torch.pipeline.diagram import pipeline_diagram
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
    "PipelineCache",
    "PipelineConfig",
    "PipelineProfiler",
    "PipelineState",
    "RecPipelineBuilder",
    "component_inputs",
    "component_return_type",
    "hash_config",
    "pipeline_diagram",
    "predict_pipeline",
    "summarize_profile",
    "topn_pipeline",
]
