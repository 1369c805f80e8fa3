"""
Mermaid diagrams of pipelines (port of ``lkpy_tpu/pipeline/diagram.py``;
reference: src/lenskit/pipeline/_diagram.py).
"""

from __future__ import annotations

from lkpy_tpu_torch.pipeline.nodes import ComponentNode, FallbackNode, InputNode, LiteralNode

__all__ = ["pipeline_diagram"]


def pipeline_diagram(pipeline) -> str:
    """Render the pipeline graph as a Mermaid flowchart."""
    lines = ["flowchart TD"]

    def nid(name: str) -> str:
        return name.replace("-", "_").replace("#", "_")

    for node in pipeline.nodes:
        if isinstance(node, InputNode):
            lines.append(f"    {nid(node.name)}[/{node.name}/]")
        elif isinstance(node, LiteralNode):
            lines.append(f"    {nid(node.name)}([{node.name}])")
        elif isinstance(node, FallbackNode):
            lines.append(f"    {nid(node.name)}{{{{{node.name}}}}}")
            for alt in node.alternatives:
                lines.append(f"    {nid(alt)} -.-> {nid(node.name)}")
        elif isinstance(node, ComponentNode):
            comp = type(node.component).__name__
            lines.append(f"    {nid(node.name)}[{node.name}<br/><i>{comp}</i>]")
            for iname, src in node.inputs.items():
                lines.append(f"    {nid(src)} -->|{iname}| {nid(node.name)}")
    for alias, target in pipeline._aliases.items():
        if alias != "default":
            lines.append(f"    {nid(target)} -.->|alias| {nid(alias)}(({alias}))")
    return "\n".join(lines)
