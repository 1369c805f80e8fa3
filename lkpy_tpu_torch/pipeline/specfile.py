"""
Pipeline spec files — the shipped ``pipelines/`` library format (port of
``lkpy_tpu/pipeline/specfile.py``).

Capability parity with the reference's ready-made pipeline configs
(reference: pipelines/als-implicit.toml:1, als-implicit-search.toml:1 and
src/lenskit/schemas/pipeline spec handling): a small TOML shape that names
a standard pipeline base, a scorer class, its config, and (for ``-search``
files) a hyperparameter space:

.. code-block:: toml

    [meta]
    name = "als-implicit"

    [options]
    base = "std:topn"          # or "std:topn-predict"
    # list_length = 100        # optional

    [components.scorer]
    class = "lkpy_tpu.models.als:ImplicitMFScorer"   # read as lkpy_tpu_torch.models.als
    config = { user_embeddings = true }

Search files add ``[search]`` (max_points, metric, list_length) and
``[space.scorer]`` dimensions (each a :class:`~lkpy_tpu_torch.tuning.ParamSpace`
mapping; dotted keys address sub-config fields and ``scale = "pow2"`` /
``"log"`` follow the reference's vocabulary), plus ``[pipeline] file =``
pointing at the base pipeline file.

The shipped files name the JAX package's classes (``lkpy_tpu.models...``).
The port reads the same files: a leading ``lkpy_tpu.`` in a class path is
rewritten to ``lkpy_tpu_torch.`` as a string (:func:`port_class_path`)
before anything is imported, so the JAX package is never loaded.
"""

from __future__ import annotations

import tomllib
from pathlib import Path

__all__ = ["PipelineSpec", "load_pipeline_file", "load_search_file", "is_search_file", "port_class_path"]

_JAX_PACKAGE = "lkpy_tpu."


def port_class_path(path: str) -> str:
    """The port's class for a class path of the JAX package: a leading
    ``lkpy_tpu.`` becomes ``lkpy_tpu_torch.``; any other path is kept."""
    if path.startswith(_JAX_PACKAGE):
        return "lkpy_tpu_torch." + path[len(_JAX_PACKAGE):]
    return path


class PipelineSpec:
    """Parsed pipeline spec file."""

    def __init__(self, name: str, base: str, scorer_class: str, config: dict, list_length=None):
        self.name = name
        self.base = base
        self.scorer_class = scorer_class
        self.config = config
        self.list_length = list_length

    @property
    def predicts_ratings(self) -> bool:
        return self.base == "std:topn-predict"

    def make_scorer(self):
        from lkpy_tpu_torch.cli.common import resolve_model

        return resolve_model(self.scorer_class, self.config)

    def build(self, n: int | None = None):
        """Build the (untrained) pipeline."""
        from lkpy_tpu_torch.pipeline import topn_pipeline

        return topn_pipeline(
            self.make_scorer(),
            predicts_ratings=self.predicts_ratings,
            n=n if n is not None else self.list_length,
            name=self.name,
        )


def _parse_pipeline_tables(data: dict, path: Path) -> PipelineSpec:
    meta = data.get("meta", {})
    options = data.get("options", {})
    base = options.get("base", "std:topn")
    if base not in ("std:topn", "std:topn-predict"):
        raise ValueError(f"{path}: unknown pipeline base {base!r}")
    comps = data.get("components", {})
    scorer = comps.get("scorer")
    if not scorer or "class" not in scorer:
        raise ValueError(f"{path}: missing [components.scorer] class")
    cls = scorer["class"]
    if ":" not in cls and "." in cls:
        # accept dotted reference-style paths ("pkg.mod.Class")
        mod, _, name = cls.rpartition(".")
        cls = f"{mod}:{name}"
    return PipelineSpec(
        meta.get("name", path.stem),
        base,
        port_class_path(cls),
        dict(scorer.get("config", {})),
        options.get("list_length"),
    )


def load_pipeline_file(path) -> PipelineSpec:
    """Load a pipeline spec TOML (reference: pipelines/als-implicit.toml)."""
    path = Path(path)
    with open(path, "rb") as f:
        data = tomllib.load(f)
    return _parse_pipeline_tables(data, path)


def is_search_file(path) -> bool:
    """True when the TOML has a ``[search]`` or ``[space]`` table."""
    with open(path, "rb") as f:
        data = tomllib.load(f)
    return "search" in data or "space" in data


#: ranking metrics whose RunAnalysis labels carry an ``@n`` suffix
_RANKING_METRICS = {"NDCG", "RBP", "Precision", "Recall", "RecipRank", "Hit", "MAP"}


def load_search_file(path, data: dict | None = None):
    """Load a ``-search`` spec TOML into a :class:`~lkpy_tpu_torch.tuning.TuningSpec`
    (reference: pipelines/als-implicit-search.toml).  ``data`` may carry the
    already-parsed TOML (callers that dispatched on its shape avoid a
    second read)."""
    from lkpy_tpu_torch.tuning import ParamSpace, TuningSpec

    path = Path(path)
    if data is None:
        with open(path, "rb") as f:
            data = tomllib.load(f)
    search = data.get("search", {})
    # the pipeline may be referenced by file or embedded under [pipeline]
    pdata = data.get("pipeline", {})
    if "file" in pdata:
        pipe = load_pipeline_file(path.parent / pdata["file"])
    elif pdata:
        pipe = _parse_pipeline_tables(pdata, path)
    else:
        raise ValueError(f"{path}: search spec needs [pipeline] file= or embedded tables")

    n_recs = int(search.get("list_length", 20))
    metric = search.get("metric", "NDCG")
    if "@" not in metric and metric in _RANKING_METRICS:
        metric = f"{metric}@{n_recs}"
    # flatten nested space dims to dotted keys (reference nests sub-fields)
    space: dict[str, ParamSpace] = {}

    def walk(prefix: str, node: dict):
        if any(k in node for k in ("type", "min", "max", "choices")) and not any(
            isinstance(v, dict) for v in node.values()
        ):
            space[prefix] = ParamSpace.model_validate(node)
            return
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}.{k}" if prefix else k, v)

    walk("", data.get("space", {}).get("scorer", {}))
    kwargs = {}
    if "max_epochs" in search:
        # epoch-capped searches run the per-epoch plateau-stopped trials
        # (reference: iterative Optuna trials, tuning/search.py:135)
        kwargs = {"max_epochs": int(search["max_epochs"]), "method": "iterative"}
    return TuningSpec(
        model=pipe.scorer_class,
        space=space,
        metric=metric,
        mode="minimize" if metric == "RMSE" else "maximize",
        max_points=int(search.get("max_points", 20)),
        predicts_ratings=pipe.predicts_ratings or metric == "RMSE",
        n_recs=n_recs,
        fixed=dict(pipe.config),
        **kwargs,
    )
