"""Shared CLI helpers (port of ``lkpy_tpu/cli/common.py``)."""

from __future__ import annotations

import json
from importlib import import_module
from pathlib import Path

from lkpy_tpu_torch.data import Dataset, load_movielens
from lkpy_tpu_torch.pipeline.specfile import port_class_path

# model registry: short names -> scorer class paths (the reference resolves
# components from pipeline config files; we also offer shorthand)
MODEL_REGISTRY = {
    "bias": "lkpy_tpu_torch.models.bias:BiasScorer",
    "pop": "lkpy_tpu_torch.models.basic:PopScorer",
    "als-biased": "lkpy_tpu_torch.models.als:BiasedMFScorer",
    "als-implicit": "lkpy_tpu_torch.models.als:ImplicitMFScorer",
    "item-knn": "lkpy_tpu_torch.models.knn:ItemKNNScorer",
    "user-knn": "lkpy_tpu_torch.models.knn:UserKNNScorer",
    "ease": "lkpy_tpu_torch.models.ease:EASEScorer",
    "slim": "lkpy_tpu_torch.models.slim:SLIMScorer",
    "association": "lkpy_tpu_torch.models.association:AssociationScorer",
    "funksvd": "lkpy_tpu_torch.models.funksvd:FunkSVDScorer",
    "flexmf-explicit": "lkpy_tpu_torch.models.flexmf:FlexMFExplicitScorer",
    "flexmf-implicit": "lkpy_tpu_torch.models.flexmf:FlexMFImplicitScorer",
    "lightgcn": "lkpy_tpu_torch.models.lightgcn:LightGCNScorer",
    "biased-svd": "lkpy_tpu_torch.models.svd:BiasedSVDScorer",
    "nmf": "lkpy_tpu_torch.models.nmf:NMFScorer",
}


def resolve_model(spec: str, params: dict | None = None):
    """A scorer from a registry name or a ``module:Class`` path; a path of
    the JAX package (``lkpy_tpu.models...``) names the port's class."""
    path = port_class_path(MODEL_REGISTRY.get(spec, spec))
    mod_name, _, cls_name = path.partition(":")
    mod = import_module(mod_name)
    cls = getattr(mod, cls_name)
    return cls(cls.validate_config(params or {}))


def load_dataset(path: str | Path) -> Dataset:
    path = Path(path)
    if (path / "schema.json").exists():
        return Dataset.load(path)
    return load_movielens(path)


def parse_params(params: tuple[str, ...]) -> dict:
    out = {}
    for p in params:
        k, _, v = p.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out
