"""The port's pipeline tooling against the JAX package's on the CPU: the
Mermaid text of ``pipeline_diagram`` (the standard pipelines and a built
one with a literal, a fallback and aliases), ``PipelineCache``
(instances shared by class and configuration) and
``component_return_type``."""

import pytest

import lkpy_tpu.models.basic as jax_basic
import lkpy_tpu.models.bias as jax_bias
import lkpy_tpu.models.knn as jax_knn
import lkpy_tpu.pipeline as jax_pipeline
import lkpy_tpu_torch.models.basic as basic
import lkpy_tpu_torch.models.bias as bias
import lkpy_tpu_torch.models.knn as knn
import lkpy_tpu_torch.pipeline as pipeline
from lkpy_tpu_torch.data import ItemList


def _standard(pkg, models):
    bias_mod, knn_mod, basic_mod = models
    return {
        "topn-bias": pkg.topn_pipeline(bias_mod.BiasScorer(damping=5.0), n=10),
        "topn-knn": pkg.topn_pipeline(knn_mod.ItemKNNScorer(feedback="implicit"), n=5, name="knn"),
        "predict": pkg.predict_pipeline(bias_mod.BiasScorer()),
        "predict-fallback": pkg.predict_pipeline(knn_mod.ItemKNNScorer(), fallback=bias_mod.BiasScorer()),
        "topn-pop": pkg.topn_pipeline(basic_mod.PopScorer()),
    }


def _built(pkg, basic_mod):
    pb = pkg.PipelineBuilder("probe")
    query = pb.create_input("query")
    items = pb.create_input("items", ItemList if pkg is pipeline else None)
    n = pb.literal(7, name="n-lit")
    pop = pb.add_component("pop-scorer", basic_mod.PopScorer(), query=query, items=items)
    other = pb.add_component("pop#2", basic_mod.PopScorer(), query=query, items=items)
    first = pb.use_first_of("first-scores", pop, other)
    pb.add_component("ranker", basic_mod.TopNRanker(), items=first, n=n)
    pb.alias("recommender", "ranker")
    pb.alias("scores", first)
    pb.default_component("ranker")
    return pb.build()


def test_diagrams_equal_jax():
    got = _standard(pipeline, (bias, knn, basic))
    want = _standard(jax_pipeline, (jax_bias, jax_knn, jax_basic))
    for name in want:
        text = pipeline.pipeline_diagram(got[name])
        assert text == jax_pipeline.pipeline_diagram(want[name]), name
        assert text.startswith("flowchart TD\n")
    text = pipeline.pipeline_diagram(_built(pipeline, basic))
    assert text == jax_pipeline.pipeline_diagram(_built(jax_pipeline, jax_basic))
    for part in ("n_lit([n-lit])", "first_scores{{first-scores}}", "pop_2 -.-> first_scores", "-.->|alias| recommender((recommender))", "<i>TopNRanker</i>"):
        assert part in text


def test_pipeline_cache_matches_jax():
    got, want = pipeline.PipelineCache(), jax_pipeline.PipelineCache()
    for cache, mod in ((got, bias), (want, jax_bias)):
        a = cache.get_instance(mod.BiasScorer, {"damping": 5.0})
        assert cache.get_instance(mod.BiasScorer, {"damping": 5.0}) is a
        validated = mod.BiasScorer.validate_config({"damping": 5.0})
        assert cache.get_instance(mod.BiasScorer, validated) is cache.get_instance(mod.BiasScorer, validated)
        b = cache.get_instance(mod.BiasScorer, {"damping": 1.0})
        assert b is not a and b.config.damping == 1.0 and a.config.damping == 5.0
        assert cache.get_cached(mod.BiasScorer, None) is None
        c = cache.get_instance(mod.BiasScorer, None)
        assert cache.get_cached(mod.BiasScorer, {}) is c
        plain = cache.get_instance(dict, None)
        assert plain == {} and cache.get_instance(dict, None) is plain
    # the same keys: module and class paths differ only by the package's name
    assert [(k[0].replace("lkpy_tpu_torch", "lkpy_tpu"), k[1]) for k in got._cache] == list(want._cache)


class _Annotated:
    def __call__(self, items: ItemList) -> ItemList:
        return items


class _Unresolvable:
    def __call__(self, items) -> "NoSuchName":  # noqa: F821
        return items


def _fn(x: int) -> float:
    return float(x)


def _bare(x):
    return x


@pytest.mark.parametrize("component", [_Annotated(), _Unresolvable(), _fn, _bare])
def test_component_return_type_matches_jax(component):
    got = pipeline.component_return_type(component)
    want = jax_pipeline.component_return_type(component)
    assert got == want
    assert pipeline.component_return_type(basic.PopScorer()) is ItemList
    assert jax_pipeline.component_return_type(jax_basic.PopScorer()).__name__ == "ItemList"


def test_public_pipeline_names_match_jax():
    assert set(jax_pipeline.__all__) <= set(pipeline.__all__)
