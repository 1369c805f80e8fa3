"""
PipelineBuilder: constructing pipeline graphs.

Port of ``lkpy_tpu/pipeline/builder.py``; capability parity with the reference ``PipelineBuilder``
(reference: src/lenskit/pipeline/_builder.py:58 with ``create_input`` :192,
``add_component`` :335, ``connect`` :449, ``use_first_of`` :308,
``alias`` :308, ``build`` :860, ``from_config``).
"""

from __future__ import annotations

from typing import Any, Sequence

from lkpy_tpu_torch.diagnostics import PipelineError
from lkpy_tpu_torch.pipeline.components import component_inputs, instantiate_component
from lkpy_tpu_torch.pipeline.config import PipelineConfig
from lkpy_tpu_torch.pipeline.nodes import ComponentNode, FallbackNode, InputNode, LiteralNode, Node

__all__ = ["PipelineBuilder"]


class PipelineBuilder:
    """
    Builder for :class:`~lkpy_tpu_torch.pipeline.Pipeline` graphs.

    Args:
        name: pipeline name (stored in metadata).
        version: pipeline version string.
    """

    def __init__(self, name: str | None = None, version: str | None = None):
        self.name = name
        self.version = version
        self._nodes: dict[str, Node] = {}
        self._aliases: dict[str, str] = {}
        self._defaults: dict[str, str] = {}
        self._anon_count = 0

    # ---- node management -------------------------------------------------
    def node(self, name: str | Node, *, missing: str = "error") -> Node | None:
        if isinstance(name, Node):
            return name
        target = self._aliases.get(name, name)
        n = self._nodes.get(target)
        if n is None and missing == "error":
            raise KeyError(f"no pipeline node {name!r}")
        return n

    @property
    def nodes(self) -> list[Node]:
        return list(self._nodes.values())

    def _check_name(self, name: str):
        if name in self._nodes or name in self._aliases:
            raise PipelineError(f"pipeline already has a node named {name!r}")

    def create_input(self, name: str, *types: type | None, required: bool | None = None) -> Node:
        """Create a pipeline input (reference: _builder.py:192)."""
        self._check_name(name)
        tts = tuple(t for t in types if t is not None and t is not type(None))
        req = required if required is not None else type(None) not in types
        node = InputNode(name, tts or None, required=req)
        self._nodes[name] = node
        return node

    def literal(self, value: Any, *, name: str | None = None) -> Node:
        if name is None:
            self._anon_count += 1
            name = f"literal#{self._anon_count}"
        self._check_name(name)
        node = LiteralNode(name, (type(value),), value=value)
        self._nodes[name] = node
        return node

    def add_component(self, name: str, component: Any, config: Any = None, /, **inputs) -> Node:
        """Add a component node (reference: _builder.py:335)."""
        self._check_name(name)
        if isinstance(component, type):
            component = component(config) if config is not None else component()
        node = ComponentNode(name, None, component=component)
        self._nodes[name] = node
        self.connect(node, **inputs)
        return node

    def replace_component(self, name: str, component: Any, config: Any = None, /, **inputs) -> Node:
        old = self.node(name)
        if isinstance(component, type):
            component = component(config) if config is not None else component()
        node = ComponentNode(name, None, component=component, inputs=dict(getattr(old, "inputs", {})))
        self._nodes[name] = node
        if inputs:
            self.connect(node, **inputs)
        return node

    def connect(self, obj: str | Node, **inputs) -> None:
        """Wire component inputs to other nodes (reference: _builder.py:449)."""
        node = self.node(obj)
        if not isinstance(node, ComponentNode):
            raise PipelineError(f"cannot connect inputs of non-component node {node.name!r}")
        for iname, src in inputs.items():
            if isinstance(src, Node):
                node.inputs[iname] = src.name
            elif isinstance(src, str):
                # string = node reference (reference semantics)
                node.inputs[iname] = self._aliases.get(src, src)
            else:
                lit = self.literal(src)
                node.inputs[iname] = lit.name

    def alias(self, alias: str, node: str | Node) -> None:
        """Create an alias for a node (reference: _builder.py:308)."""
        n = self.node(node)
        self._check_name(alias)
        self._aliases[alias] = n.name

    def use_first_of(self, name: str, *nodes: str | Node) -> Node:
        """Create a fallback node using the first non-None input
        (reference: _builder.py:808)."""
        self._check_name(name)
        alts = [self.node(n).name for n in nodes]
        node = FallbackNode(name, None, alternatives=alts)
        self._nodes[name] = node
        return node

    def default_connection(self, input_name: str, node: str | Node) -> None:
        """Set a default wiring for unconnected component inputs of this name
        (reference: _builder.py ``default_connection``)."""
        self._defaults[input_name] = self.node(node).name

    def default_component(self, node: str | Node) -> None:
        """Set the default node run when no node is specified."""
        self.alias("default", node)

    # ---- validation + build ----------------------------------------------
    def validate(self) -> None:
        for node in self._nodes.values():
            if isinstance(node, ComponentNode):
                for iname, src in node.inputs.items():
                    if src not in self._nodes:
                        raise PipelineError(f"{node.name}.{iname} wired to missing node {src!r}")
            elif isinstance(node, FallbackNode):
                for src in node.alternatives:
                    if src not in self._nodes:
                        raise PipelineError(f"fallback {node.name} references missing node {src!r}")
        # cycle check (DFS)
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in self._nodes}

        def deps(n: Node) -> Sequence[str]:
            if isinstance(n, ComponentNode):
                return list(n.inputs.values())
            if isinstance(n, FallbackNode):
                return n.alternatives
            return []

        def visit(name: str):
            color[name] = GRAY
            for d in deps(self._nodes[name]):
                if color[d] == GRAY:
                    raise PipelineError(f"pipeline has a cycle through {d!r}")
                if color[d] == WHITE:
                    visit(d)
            color[name] = BLACK

        for name in self._nodes:
            if color[name] == WHITE:
                visit(name)

    def apply_defaults(self) -> None:
        """Wire unconnected component inputs to matching default nodes."""
        for node in self._nodes.values():
            if not isinstance(node, ComponentNode):
                continue
            for iname in component_inputs(node.component):
                if iname not in node.inputs:
                    if iname in self._defaults:
                        node.inputs[iname] = self._defaults[iname]
                    elif iname in self._nodes and isinstance(self._nodes[iname], InputNode):
                        node.inputs[iname] = iname

    def build(self) -> "Pipeline":
        """Finalize into an immutable Pipeline (reference: _builder.py:860)."""
        from lkpy_tpu_torch.pipeline.pipeline import Pipeline

        self.apply_defaults()
        self.validate()
        return Pipeline(
            dict(self._nodes),
            dict(self._aliases),
            dict(self._defaults),
            name=self.name,
            version=self.version,
        )

    def clone(self) -> "PipelineBuilder":
        import copy

        pb = PipelineBuilder(self.name, self.version)
        pb._nodes = copy.deepcopy(self._nodes)
        pb._aliases = dict(self._aliases)
        pb._defaults = dict(self._defaults)
        return pb

    # ---- config round-trip -----------------------------------------------
    @classmethod
    def from_config(cls, config: PipelineConfig | dict) -> "PipelineBuilder":
        """Reconstruct a builder from a serialized config (reference: _builder.py ``from_config``)."""
        if isinstance(config, dict):
            config = PipelineConfig.model_validate(config)
        pb = cls(config.meta.name, config.meta.version)
        for inp in config.inputs:
            node = InputNode(inp.name, None, required=inp.required)
            pb._nodes[inp.name] = node
        for name, lit in config.literals.items():
            pb._nodes[name] = LiteralNode(name, None, value=lit.data)
        for name, comp in config.components.items():
            component = instantiate_component(comp.code, comp.config)
            pb._nodes[name] = ComponentNode(name, None, component=component, inputs=dict(comp.inputs))
        for name, alts in config.fallbacks.items():
            pb._nodes[name] = FallbackNode(name, None, alternatives=list(alts))
        pb._aliases = dict(config.aliases)
        pb._defaults = dict(config.defaults)
        return pb
