"""
Pipeline: the recommendation DAG.

Port of ``lkpy_tpu/pipeline/pipeline.py``; capability parity with the reference ``Pipeline``
(reference: src/lenskit/pipeline/_impl.py:47; ``run`` :400, ``run_all`` :453,
``train`` :316) and the recursive ``PipelineRunner``
(reference: src/lenskit/pipeline/_runner.py:36).
"""

from __future__ import annotations

import time
from typing import Any, Callable

from lkpy_tpu_torch.diagnostics import PipelineError
from lkpy_tpu_torch.lazy import Lazy, LazyValue
from lkpy_tpu_torch.logging import Stopwatch, get_logger, trace
from lkpy_tpu_torch.pipeline.components import Component, class_path, component_inputs
from lkpy_tpu_torch.pipeline.config import (
    PipelineComponent,
    PipelineConfig,
    PipelineInput,
    PipelineLiteral,
    PipelineMeta,
    hash_config,
)
from lkpy_tpu_torch.pipeline.nodes import ComponentNode, FallbackNode, InputNode, LiteralNode, Node
from lkpy_tpu_torch.training import Trainable, TrainingOptions


def _is_lazy_hint(hint) -> bool:
    """Whether a component input annotation is ``Lazy[...]`` (deferral)."""
    if hint is None:
        return False
    from typing import get_origin

    return (get_origin(hint) or hint) is Lazy

_log = get_logger(__name__)

__all__ = ["Pipeline", "PipelineState"]


class PipelineState(dict):
    """Results of running pipeline nodes (reference: pipeline/_state.py:14)."""

    @property
    def default(self) -> Any:
        return self.get("default")


class Pipeline:
    """
    An immutable pipeline of components.

    Create with :class:`~lkpy_tpu_torch.pipeline.PipelineBuilder`.
    """

    def __init__(
        self,
        nodes: dict[str, Node],
        aliases: dict[str, str],
        defaults: dict[str, str] | None = None,
        *,
        name: str | None = None,
        version: str | None = None,
    ):
        self._nodes = nodes
        self._aliases = aliases
        self._defaults = defaults or {}
        self.name = name
        self.version = version
        self._hooks: dict[str, list[Callable]] = {"component-input": []}

    # ---- structure -------------------------------------------------------
    @property
    def nodes(self) -> list[Node]:
        return list(self._nodes.values())

    def node(self, name: str | Node, *, missing: str = "error") -> Node | None:
        if isinstance(name, Node):
            return name
        target = self._aliases.get(name, name)
        n = self._nodes.get(target)
        if n is None and missing == "error":
            raise KeyError(f"no pipeline node {name!r}")
        return n

    def node_names(self) -> list[str]:
        return list(self._nodes.keys())

    def component_nodes(self) -> list[ComponentNode]:
        return [n for n in self._nodes.values() if isinstance(n, ComponentNode)]

    def components(self) -> dict[str, Any]:
        return {n.name: n.component for n in self.component_nodes()}

    @property
    def default_node_name(self) -> str | None:
        if "default" in self._aliases:
            return self._aliases["default"]
        return None

    def modify(self) -> "PipelineBuilder":
        """A builder initialized with this pipeline's structure."""
        import copy

        from lkpy_tpu_torch.pipeline.builder import PipelineBuilder

        pb = PipelineBuilder(self.name, self.version)
        pb._nodes = copy.deepcopy(self._nodes)
        pb._aliases = dict(self._aliases)
        pb._defaults = dict(self._defaults)
        return pb

    def clone(self) -> "Pipeline":
        """A fresh (untrained) copy with the same structure and configs
        (reference: _impl.py ``clone``)."""
        from lkpy_tpu_torch.pipeline.builder import PipelineBuilder

        return PipelineBuilder.from_config(self.get_config()).build()

    # ---- hooks -----------------------------------------------------------
    def add_run_hook(self, kind: str, hook: Callable) -> None:
        """Register a run hook (reference: pipeline/_hooks/__init__.py:53).

        ``component-input`` hooks are called as
        ``hook(node_name, input_name, value)`` and may return a replacement
        value.
        """
        if kind not in self._hooks:
            raise ValueError(f"unknown hook kind {kind!r}")
        self._hooks[kind].append(hook)

    # ---- config ----------------------------------------------------------
    def get_config(self) -> PipelineConfig:
        """Serialize structure + component configs (reference: _impl.py:226-243)."""
        cfg = PipelineConfig(meta=PipelineMeta(name=self.name, version=self.version))
        for node in self._nodes.values():
            if isinstance(node, InputNode):
                cfg.inputs.append(PipelineInput(name=node.name, required=node.required))
            elif isinstance(node, LiteralNode):
                cfg.literals[node.name] = PipelineLiteral(data=node.value)
            elif isinstance(node, FallbackNode):
                cfg.fallbacks[node.name] = list(node.alternatives)
            elif isinstance(node, ComponentNode):
                comp = node.component
                if isinstance(comp, Component):
                    code = class_path(type(comp))
                    conf = comp.dump_config()
                else:
                    code = class_path(comp if isinstance(comp, type) else type(comp))
                    conf = {}
                    if callable(comp) and not isinstance(comp, type) and hasattr(comp, "__module__"):
                        code = f"{comp.__module__}:{comp.__qualname__}"
                cfg.components[node.name] = PipelineComponent(code=code, config=conf, inputs=dict(node.inputs))
        cfg.aliases = dict(self._aliases)
        cfg.defaults = dict(self._defaults)
        cfg.meta.hash = hash_config(cfg)
        return cfg

    def config_hash(self) -> str:
        """Stable SHA-256 hash of the pipeline configuration."""
        return hash_config(self.get_config())

    @classmethod
    def from_config(cls, config: PipelineConfig | dict) -> "Pipeline":
        from lkpy_tpu_torch.pipeline.builder import PipelineBuilder

        return PipelineBuilder.from_config(config).build()

    # ---- training --------------------------------------------------------
    def train(self, data: Any, options: TrainingOptions | None = None) -> None:
        """Train all trainable components in topological order
        (reference: _impl.py:316, seed spawning :346-364)."""
        from lkpy_tpu_torch.random import derive_seed

        options = options or TrainingOptions()
        for name in self._topo_order():
            node = self._nodes[name]
            if isinstance(node, ComponentNode) and isinstance(node.component, Trainable):
                import numpy as np

                if not options.retrain:
                    # skip already-trained components (reference: _impl.py:359)
                    trained = getattr(node.component, "is_trained", False)
                    if callable(trained):
                        trained = trained()
                    if trained:
                        _log.debug("component already trained; skipping", node=name)
                        continue

                base = options.rng if not isinstance(options.rng, np.random.Generator) else None
                comp_opts = TrainingOptions(
                    retrain=options.retrain,
                    device=options.device,
                    rng=derive_seed(name, base=base),
                )
                log = _log.bind(node=name, component=type(node.component).__name__)
                with Stopwatch() as sw:
                    node.component.train(data, comp_opts)
                log.info("trained component", time=str(sw))

    def _topo_order(self) -> list[str]:
        order: list[str] = []
        seen: set[str] = set()

        def deps(n: Node):
            if isinstance(n, ComponentNode):
                return n.inputs.values()
            if isinstance(n, FallbackNode):
                return n.alternatives
            return []

        def visit(name: str):
            if name in seen:
                return
            seen.add(name)
            for d in deps(self._nodes[name]):
                visit(d)
            order.append(name)

        for name in self._nodes:
            visit(name)
        return order

    # ---- running ---------------------------------------------------------
    def run(self, *nodes: str | Node, **kwargs) -> Any:
        """Run the pipeline and return the (last) requested node's output
        (reference: _impl.py:400)."""
        state = self.run_all(*nodes, **kwargs)
        if nodes:
            last = nodes[-1]
            last = last.name if isinstance(last, Node) else self._aliases.get(last, last)
            return state[last]
        dflt = self.default_node_name
        if dflt is None:
            raise PipelineError("no node specified and pipeline has no default")
        return state[dflt]

    def run_all(self, *nodes: str | Node, _profile=None, **kwargs) -> PipelineState:
        """Run and return state for all executed nodes (reference: _impl.py:453).

        ``_profile``: a :class:`~lkpy_tpu_torch.pipeline.profiling.PipelineProfiler`
        to record per-component wall times (the host's clock) for this run."""
        runner = _Runner(self, kwargs, profiler=_profile)
        targets = list(nodes)
        if not targets:
            dflt = self.default_node_name
            if dflt is None:
                targets = [n.name for n in self._nodes.values()]
            else:
                targets = [dflt]
        for t in targets:
            node = self.node(t)
            runner.run(node)
        if _profile is not None and runner.timings:
            _profile.record(runner.timings)
        return PipelineState(runner.state)


class _Runner:
    """Recursive DFS executor (reference: pipeline/_runner.py:36,64)."""

    def __init__(self, pipe: Pipeline, inputs: dict[str, Any], *, profiler=None):
        self.pipe = pipe
        self.inputs = inputs
        self.state: dict[str, Any] = {}
        self.in_progress: set[str] = set()
        self.profiler = profiler
        self.timings: dict[str, float] = {}

    def run(self, node: Node, *, required: bool = True) -> Any:
        if node.name in self.state:
            return self.state[node.name]
        if node.name in self.in_progress:
            raise PipelineError(f"pipeline cycle through {node.name!r}")
        self.in_progress.add(node.name)
        trace(_log, "running node", node=node.name)
        try:
            if isinstance(node, InputNode):
                value = self._input_value(node, required)
            elif isinstance(node, LiteralNode):
                value = node.value
            elif isinstance(node, FallbackNode):
                value = None
                for alt in node.alternatives:
                    value = self.run(self.pipe._nodes[alt], required=False)
                    if value is not None:
                        break
            elif isinstance(node, ComponentNode):
                value = self._run_component(node)
            else:  # pragma: no cover
                raise PipelineError(f"unknown node type {type(node)}")
        except Exception as e:
            _log.error("node failed", node=node.name, error=str(e))
            raise
        finally:
            self.in_progress.discard(node.name)
        self.state[node.name] = value
        return value

    def _input_value(self, node: InputNode, required: bool) -> Any:
        if node.name in self.inputs:
            value = self.inputs[node.name]
            if value is not None and node.types and not isinstance(value, node.types):
                # allow query coercion
                raise TypeError(
                    f"input {node.name!r}: expected {node.types}, got {type(value)}"
                )
            return value
        if node.required and required:
            raise PipelineError(f"required pipeline input {node.name!r} not provided")
        return None

    def _run_component(self, node: ComponentNode) -> Any:
        comp = node.component
        sig_inputs = component_inputs(comp)
        kwargs = {}
        for iname, hint in sig_inputs.items():
            src = node.inputs.get(iname)
            if src is None:
                continue
            if _is_lazy_hint(hint):
                # a Lazy[T]-annotated input defers its upstream node until
                # .get() is called (reference: lazy.py Lazy + pipeline
                # runner) — e.g. FallbackScorer's backup scorer only runs
                # when scores are actually missing.  Profiling caveat: a
                # deferred node that does run executes inside the consumer's
                # timed call, so its duration appears under both nodes.
                src_node = self.pipe._nodes[src]

                def _thunk(n=src_node, nm=node.name, inm=iname):
                    value = self.run(n)
                    for hook in self.pipe._hooks["component-input"]:
                        res = hook(nm, inm, value)
                        if res is not None:
                            value = res
                    return value

                kwargs[iname] = LazyValue(_thunk)
                continue
            value = self.run(self.pipe._nodes[src])
            for hook in self.pipe._hooks["component-input"]:
                res = hook(node.name, iname, value)
                if res is not None:
                    value = res
            kwargs[iname] = value
        if self.profiler is not None:
            t0 = time.perf_counter()
            result = comp(**kwargs)
            self.timings[node.name] = time.perf_counter() - t0
            return result
        return comp(**kwargs)
