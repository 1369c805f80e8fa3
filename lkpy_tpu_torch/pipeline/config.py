"""
Pipeline configuration schema + hashing.

Port of ``lkpy_tpu/pipeline/config.py``; capability parity with the reference pipeline config schema
(reference: src/lenskit/schemas/pipeline.py, incl. ``hash_config`` SHA-256)
— pipelines serialize to JSON/YAML/TOML-able dicts and have stable content
hashes.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

from pydantic import BaseModel, Field

__all__ = ["PipelineConfig", "PipelineInput", "PipelineComponent", "PipelineLiteral", "PipelineMeta", "hash_config"]


class PipelineMeta(BaseModel):
    name: str | None = None
    version: str | None = None
    hash: str | None = None


class PipelineInput(BaseModel):
    name: str
    types: list[str] | None = None
    required: bool = True


class PipelineComponent(BaseModel):
    code: str  # module:Class path
    config: dict[str, Any] = Field(default_factory=dict)
    inputs: dict[str, str] = Field(default_factory=dict)


class PipelineLiteral(BaseModel):
    encoding: str = "json"
    data: Any = None


class PipelineConfig(BaseModel):
    meta: PipelineMeta = Field(default_factory=PipelineMeta)
    inputs: list[PipelineInput] = Field(default_factory=list)
    components: dict[str, PipelineComponent] = Field(default_factory=dict)
    literals: dict[str, PipelineLiteral] = Field(default_factory=dict)
    fallbacks: dict[str, list[str]] = Field(default_factory=dict)
    aliases: dict[str, str] = Field(default_factory=dict)
    defaults: dict[str, str] = Field(default_factory=dict)


def hash_config(config: BaseModel | dict) -> str:
    """SHA-256 hash of a canonical-JSON config (reference: schemas/pipeline.py ``hash_config``)."""
    if isinstance(config, BaseModel):
        data = config.model_dump(mode="json", exclude_none=True)
    else:
        data = config
    data = dict(data)
    meta = data.get("meta")
    if isinstance(meta, dict):
        meta = dict(meta)
        meta.pop("hash", None)
        data["meta"] = meta
    canon = json.dumps(data, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf8")).hexdigest()
