"""
Pipeline graph nodes (port of ``lkpy_tpu/pipeline/nodes.py``; reference:
src/lenskit/pipeline/nodes.py:36-201).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

__all__ = ["Node", "InputNode", "LiteralNode", "ComponentNode", "FallbackNode"]


@dataclass
class Node:
    """A node in the pipeline graph."""

    name: str
    types: tuple[type, ...] | None = None

    def __hash__(self):
        return hash(self.name)


@dataclass
class InputNode(Node):
    """A pipeline input (reference: nodes.py ``InputNode``)."""

    required: bool = True


@dataclass
class LiteralNode(Node):
    """A constant value node."""

    value: Any = None


@dataclass
class ComponentNode(Node):
    """A component invocation node; ``inputs`` maps parameter names to node names."""

    component: Any = None
    inputs: dict[str, str] = field(default_factory=dict)

    def __hash__(self):
        return hash(self.name)


@dataclass
class FallbackNode(Node):
    """Use the first non-None input (reference: _builder.py:308 ``use_first_of``)."""

    alternatives: list[str] = field(default_factory=list)

    def __hash__(self):
        return hash(self.name)
