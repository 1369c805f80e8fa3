"""The shipped ``pipelines/*.toml`` through the port's spec-file loader,
against the JAX package's.

Every file loads through both packages to the same name, base, config,
list length and rating flag; the port's class path is the JAX one with
``lkpy_tpu.`` read as ``lkpy_tpu_torch.``.  Every ``*-search.toml`` gives
the JAX package's ``TuningSpec`` but for ``model``.  A fresh interpreter
loads and builds every file through the port alone and holds that neither
``jax`` nor ``lkpy_tpu`` was imported.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from lkpy_tpu.pipeline.specfile import is_search_file as jax_is_search_file
from lkpy_tpu.pipeline.specfile import load_pipeline_file as jax_load_pipeline_file
from lkpy_tpu.pipeline.specfile import load_search_file as jax_load_search_file
from lkpy_tpu_torch.models.als import ImplicitMFScorer
from lkpy_tpu_torch.pipeline.specfile import (
    is_search_file,
    load_pipeline_file,
    load_search_file,
    port_class_path,
)
from lkpy_tpu_torch.tuning import TuningSpec

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "pipelines").glob("*.toml"))
PIPELINE_FILES = [f for f in FILES if not f.stem.endswith("-search")]
SEARCH_FILES = [f for f in FILES if f.stem.endswith("-search")]


def test_every_shipped_file_is_covered():
    assert len(FILES) == 17 and len(SEARCH_FILES) == 7
    for f in FILES:
        assert is_search_file(f) == jax_is_search_file(f) == (f in SEARCH_FILES)


@pytest.mark.parametrize("path", PIPELINE_FILES, ids=lambda p: p.stem)
def test_pipeline_file_equals_jax(path):
    got, want = load_pipeline_file(path), jax_load_pipeline_file(path)
    assert (got.name, got.base, got.config, got.list_length, got.predicts_ratings) == (
        want.name,
        want.base,
        want.config,
        want.list_length,
        want.predicts_ratings,
    )
    assert want.scorer_class.startswith("lkpy_tpu.models.")
    assert got.scorer_class == "lkpy_tpu_torch." + want.scorer_class[len("lkpy_tpu.") :]


@pytest.mark.parametrize("path", SEARCH_FILES, ids=lambda p: p.stem)
def test_search_file_equals_jax(path):
    got, want = load_search_file(path), jax_load_search_file(path)
    assert isinstance(got, TuningSpec)
    assert got.model == port_class_path(want.model) != want.model
    assert got.model_dump(exclude={"model"}) == want.model_dump(exclude={"model"})


def test_als_implicit_search_space():
    spec = load_search_file(ROOT / "pipelines" / "als-implicit-search.toml")
    assert spec.metric == "RBP@1000" and spec.n_recs == 1000 and spec.max_points == 30
    assert spec.space["embedding_size"].choices == [8, 16, 32, 64, 128, 256]
    assert spec.space["regularization.user"].log and spec.space["weight"].min == 5
    assert spec.fixed == {"user_embeddings": True} and spec.method == "random"


def test_als_implicit_builds_the_pipeline_phase_scorer():
    pipe = load_pipeline_file(ROOT / "pipelines" / "als-implicit.toml").build(n=10)
    scorer = pipe.node("scorer").component
    assert isinstance(scorer, ImplicitMFScorer)
    cfg = scorer.config
    assert (cfg.embedding_size, cfg.epochs, cfg.weight, cfg.user_embeddings) == (64, 10, 40.0, True)
    assert (cfg.user_reg, cfg.item_reg) == (0.1, 0.1)


def test_class_path_mapping_and_dotted_paths(tmp_path):
    assert port_class_path("lkpy_tpu.models.bias:BiasScorer") == "lkpy_tpu_torch.models.bias:BiasScorer"
    assert port_class_path("lkpy_tpu_torch.models.bias:BiasScorer") == "lkpy_tpu_torch.models.bias:BiasScorer"
    assert port_class_path("mypkg.models:Thing") == "mypkg.models:Thing"
    spec = tmp_path / "dotted.toml"
    spec.write_text('[components.scorer]\nclass = "lkpy_tpu.models.bias.BiasScorer"\nconfig = { damping = 2.0 }\n')
    got, want = load_pipeline_file(spec), jax_load_pipeline_file(spec)
    assert want.scorer_class == "lkpy_tpu.models.bias:BiasScorer"
    assert got.scorer_class == "lkpy_tpu_torch.models.bias:BiasScorer" and got.name == want.name == "dotted"
    assert got.make_scorer().config.damping == 2.0


def test_bad_files_raise(tmp_path):
    base = tmp_path / "base.toml"
    base.write_text('[options]\nbase = "std:other"\n[components.scorer]\nclass = "lkpy_tpu.models.bias:BiasScorer"\n')
    with pytest.raises(ValueError, match="unknown pipeline base"):
        load_pipeline_file(base)
    none = tmp_path / "none.toml"
    none.write_text("[meta]\nname = 'x'\n")
    with pytest.raises(ValueError, match="missing"):
        load_pipeline_file(none)
    search = tmp_path / "s-search.toml"
    search.write_text("[search]\nmax_points = 2\n")
    with pytest.raises(ValueError, match="search spec needs"):
        load_search_file(search)


def test_subprocess_loads_every_file_without_jax():
    code = f"""
import json, sys
from pathlib import Path
from lkpy_tpu_torch.pipeline.specfile import is_search_file, load_pipeline_file, load_search_file
out = {{}}
for f in sorted(Path({str(ROOT / "pipelines")!r}).glob("*.toml")):
    if is_search_file(f):
        spec = load_search_file(f)
        out[f.stem] = spec.model
    else:
        pipe = load_pipeline_file(f).build()
        out[f.stem] = type(pipe.node("scorer").component).__module__
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "lkpy_tpu"))
assert not bad, bad
print(json.dumps(out))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out) == len(FILES)
    assert all(v.startswith("lkpy_tpu_torch.models.") for v in out.values())
