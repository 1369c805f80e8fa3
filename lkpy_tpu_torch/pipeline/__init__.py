"""
Pipeline abstraction: DAGs of recommendation components (port of
``lkpy_tpu.pipeline``; reference: src/lenskit/pipeline/__init__.py).

The pipeline diagram, profiler, cache and spec-file loader of the JAX
package are not ported yet.
"""

from lkpy_tpu_torch.pipeline.builder import PipelineBuilder
from lkpy_tpu_torch.pipeline.common import RecPipelineBuilder, predict_pipeline, topn_pipeline
from lkpy_tpu_torch.pipeline.components import Component, component_inputs
from lkpy_tpu_torch.pipeline.config import PipelineConfig, hash_config
from lkpy_tpu_torch.pipeline.nodes import ComponentNode, FallbackNode, InputNode, LiteralNode, Node
from lkpy_tpu_torch.pipeline.pipeline import Pipeline, PipelineState

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
    "PipelineState",
    "RecPipelineBuilder",
    "component_inputs",
    "hash_config",
    "predict_pipeline",
    "topn_pipeline",
]
