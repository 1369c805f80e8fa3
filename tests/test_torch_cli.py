"""The port's command line against the JAX package's, through ``CliRunner``.

Both CLIs run on the same small MovieLens-format directory, written by the
test from a seed (``tests/test_torch_loaders.py::write_movielens``); the
port runs with ``--device cpu``.  ``recommend`` prints item ids through
``DataFrame.iterrows`` in both (integer ids print as ``21.0``), so the
printed lines are compared, item for item wherever the printed scores of
the neighbouring ranks differ (ties have no order).
"""

import json
import logging
import re
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest
import torch
from click.testing import CliRunner

from lkpy_tpu.cli import cli as jax_cli
from lkpy_tpu_torch.cli import cli
from lkpy_tpu_torch.cli.common import MODEL_REGISTRY, parse_params, resolve_model
from tests.test_torch_loaders import write_movielens

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
USERS = ["1", "2", "5", "17"]

SPEC = """[meta]
name = "als-small"

[options]
base = "std:topn"

[components.scorer]
class = "lkpy_tpu.models.als:ImplicitMFScorer"
config = { embedding_size = 8, epochs = 3, user_embeddings = true }
"""

BIAS_SPEC = """[meta]
name = "bias-small"

[options]
base = "std:topn"

[components.scorer]
class = "lkpy_tpu.models.bias:BiasScorer"
"""

SEARCH = """[search]
max_points = 3
list_length = 10
metric = "NDCG"

[space.scorer]
damping = { type = "float", min = 0.5, max = 50, scale = "log" }

[pipeline]
file = "bias-small.toml"
"""


@pytest.fixture(autouse=True)
def root_logging():
    """Each CLI call applies a logging config to the root logger; put it back."""
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    yield
    for h in list(root.handlers):
        if h not in handlers:
            h.close()
        root.removeHandler(h)
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


@pytest.fixture(scope="module")
def ml(tmp_path_factory):
    return write_movielens(tmp_path_factory.mktemp("data") / "ml-small", "latest", seed=4, n_users=60, n_items=80, nnz=1500)


def run(cli_, args, **kwargs):
    res = CliRunner().invoke(cli_, [str(a) for a in args], **kwargs)
    assert res.exit_code == 0, (res.output, res.exception)
    return res.output


def same_config(port: dict, jax: dict) -> bool:
    """Equal configs once the port's class paths are read as the JAX ones;
    the hash covers the class paths, so it differs."""
    port, jax = json.loads(json.dumps(port).replace('"lkpy_tpu_torch.', '"lkpy_tpu.')), dict(jax)
    port["meta"], jax["meta"] = {**port["meta"], "hash": None}, {**jax["meta"], "hash": None}
    return port == jax


def both(args):
    """The port's output (on the CPU) and the JAX CLI's for the same arguments."""
    return run(cli, CPU + list(args)), run(jax_cli, list(args))


_LINE = re.compile(r"^\s+(\d+)\. (\S+) \((-?[\d.]+)\)$")


def parse_recs(out: str) -> dict:
    recs, user = {}, None
    for line in out.splitlines():
        if line.startswith("recommendations for user "):
            user = line.removeprefix("recommendations for user ").rstrip(":")
            recs[user] = []
        elif (m := _LINE.match(line)) is not None:
            recs[user].append((int(m[1]), m[2], m[3]))
    return recs


def assert_same_lists(got: str, want: str):
    g, w = parse_recs(got), parse_recs(want)
    assert list(g) == list(w) and all(len(w[u]) > 0 for u in w)
    compared = 0
    for u in w:
        assert [r[0] for r in g[u]] == [r[0] for r in w[u]]
        assert [float(r[2]) for r in g[u]] == pytest.approx([float(r[2]) for r in w[u]], abs=1.5e-3)
        scores = [r[2] for r in w[u]]
        for i, (_, item, _) in enumerate(w[u]):
            tied = (i > 0 and scores[i - 1] == scores[i]) or (i + 1 < len(scores) and scores[i + 1] == scores[i])
            if not tied and i + 1 < len(scores):
                assert g[u][i][1] == item, (u, i)
                compared += 1
    assert compared >= sum(len(v) for v in w.values()) // 2


def test_data_describe_equal(ml):
    got, want = both(["data", "describe", ml])
    assert got == want and "users: 60" in got


def test_data_convert_split_subset(ml, tmp_path):
    native = tmp_path / "native"
    got = run(cli, CPU + ["data", "convert", ml, native])
    assert "1500 interactions" in got and (native / "schema.json").exists()
    # the port's native copy reads back through either CLI
    assert run(cli, CPU + ["data", "describe", native]) == run(jax_cli, ["data", "describe", native])

    for cli_, out in ((cli, tmp_path / "port-split"), (jax_cli, tmp_path / "jax-split")):
        run(cli_, (CPU if cli_ is cli else []) + ["data", "split", "--users", "20", "--seed", "3", ml, out])
        assert (out / "train" / "schema.json").exists() and (out / "test.parquet").exists()
    pt, jt = pd.read_parquet(tmp_path / "port-split" / "test.parquet"), pd.read_parquet(tmp_path / "jax-split" / "test.parquet")
    pd.testing.assert_frame_equal(pt, jt)
    got, want = both(["data", "describe", tmp_path / "port-split" / "train"])
    assert got.splitlines()[1:] == run(jax_cli, ["data", "describe", tmp_path / "jax-split" / "train"]).splitlines()[1:]

    run(cli, CPU + ["data", "subset", "--min-item-count", "20", "--min-user-count", "5", ml, tmp_path / "port-sub"])
    run(jax_cli, ["data", "subset", "--min-item-count", "20", "--min-user-count", "5", ml, tmp_path / "jax-sub"])
    got = run(cli, CPU + ["data", "describe", tmp_path / "port-sub"])
    want = run(jax_cli, ["data", "describe", tmp_path / "jax-sub"])
    assert got.splitlines()[1:] == want.splitlines()[1:]
    assert int(re.search(r"items: (\d+)", got)[1]) < 80


def test_data_fetch_local_mirror(ml, tmp_path, monkeypatch):
    monkeypatch.delenv("LK_DATA_DIR", raising=False)
    res = CliRunner().invoke(cli, ["data", "fetch", "no-such-dataset", str(tmp_path / "out")])
    assert res.exit_code != 0 and "not found in local mirrors" in res.output
    out = run(cli, ["data", "fetch", "--source-dir", ml.parent, "--convert", ml.name, tmp_path / "fetched"])
    assert "native, 1500 interactions" in out and (tmp_path / "fetched" / "schema.json").exists()


def test_train_bias_and_recommend_equal(ml, tmp_path):
    outs = []
    for cli_, extra in ((cli, CPU), (jax_cli, [])):
        model = tmp_path / f"bias-{len(extra)}.pkl"
        run(cli_, extra + ["train", "-m", "bias", "-p", "damping=5.0", "-o", model, ml])
        outs.append(run(cli_, extra + ["recommend", "-m", model, "-n", "8", *USERS]))
    assert_same_lists(*outs)
    assert "recommendations for user 1:" in outs[0] and ".0 (" in outs[0]


def test_spec_file_expand_train_recommend_equal(ml, tmp_path):
    spec = tmp_path / "als-small.toml"
    spec.write_text(SPEC)
    outs, cfgs = [], []
    for cli_, extra, tag in ((cli, CPU, "port"), (jax_cli, [], "jax")):
        cfg = tmp_path / f"{tag}-cfg.json"
        run(cli_, extra + ["pipeline", "expand", "-f", spec, "-o", cfg])
        cfgs.append(json.loads(cfg.read_text()))
        model = tmp_path / f"{tag}.pkl.gz"
        run(cli_, extra + ["train", "-c", cfg, "--rng-seed", "7", "-o", model, ml])
        outs.append(run(cli_, extra + ["recommend", "-m", model, "-n", "10", "--data", ml, *USERS]))
    assert same_config(*cfgs)
    assert cfgs[0]["components"]["scorer"]["code"] == "lkpy_tpu_torch.models.als:ImplicitMFScorer"
    # --data prints titles; map them back to ids through the movie list
    movies = pd.read_csv(ml / "movies.csv")
    assert "Movie " in outs[0]
    by_title = {f"{t.split(' (')[0]}": str(float(i)) for i, t in zip(movies.movieId, movies.title)}
    norm = [re.sub(r"Movie (\d+) \(\d+\)", lambda m: by_title[f"Movie {m[1]}"], o) for o in outs]
    assert_same_lists(*norm)


def test_pipeline_expand_model_and_diagram_equal():
    got, want = both(["pipeline", "expand", "-m", "bias", "-n", "5"])
    assert same_config(json.loads(got), json.loads(want))
    got, want = both(["pipeline", "expand", "-f", ROOT / "pipelines" / "als-implicit.toml"])
    assert same_config(json.loads(got), json.loads(want))
    # the port's command prints pipeline_diagram's Mermaid text, which is
    # the JAX package's pipeline_diagram on the same pipeline
    from lkpy_tpu.cli.common import resolve_model as jax_resolve_model
    from lkpy_tpu.pipeline import pipeline_diagram as jax_pipeline_diagram
    from lkpy_tpu.pipeline import topn_pipeline as jax_topn_pipeline

    got = run(cli, CPU + ["pipeline", "diagram", "-m", "pop"])
    want = jax_pipeline_diagram(jax_topn_pipeline(jax_resolve_model("pop"), name="pop")) + "\n"
    assert got == want and got.startswith("flowchart TD") and "<i>PopScorer</i>" in got
    res = CliRunner().invoke(cli, ["pipeline", "expand"])
    assert res.exit_code != 0 and "required" in res.output


def test_config_json_equal():
    got, want = both(["config", "--json"])
    assert json.loads(got) == json.loads(want)
    got, want = both(["config"])
    assert got == want


def test_doctor_reports_torch():
    out = run(cli, ["doctor", "--full"])
    assert "lkpy-tpu-torch version: 0.1.0" in out
    assert f"torch: {torch.__version__}" in out
    assert not re.search(r"^jax", out, re.MULTILINE)
    assert "devices: " in out and "config: mesh" in out


def test_task_record_fields_equal(tmp_path):
    port, jax = tmp_path / "port.json", tmp_path / "jax.json"
    run(cli, ["task", "--save-to", port, "--label", "t", "config", "--json"])
    run(jax_cli, ["task", "--save-to", jax, "--label", "t", "config", "--json"])
    got, want = json.loads(port.read_text()), json.loads(jax.read_text())
    assert list(got) == list(want)
    assert got["label"] == "t" and got["status"] == "finished" and got["duration"] > 0


def test_task_passes_the_device_on(ml, tmp_path):
    record = tmp_path / "train.json"
    run(cli, CPU + ["task", "--save-to", record, "train", "-m", "pop", "-o", tmp_path / "pop.pkl", ml])
    rec = json.loads(record.read_text())
    assert rec["status"] == "finished" and rec["subtasks"][0]["label"] == "train pop"


def test_profile_summarize_equal(tmp_path):
    prof = tmp_path / "profile.csv"
    pd.DataFrame({"scorer": [0.5, 0.7, 0.2], "ranker": [0.1, 0.2, 0.05]}).to_csv(prof, index=False)
    got, want = both(["profile", "summarize", prof])
    assert got == want and "scorer" in got


def test_tune_search_file_equal(ml, tmp_path):
    (tmp_path / "bias-small.toml").write_text(BIAS_SPEC)
    search = tmp_path / "bias-small-search.toml"
    search.write_text(SEARCH)
    got = run(cli, CPU + ["tune", "-s", search, "-o", tmp_path / "port.json", ml])
    want = run(jax_cli, ["tune", "-s", search, "-o", tmp_path / "jax.json", ml])
    best = [[line for line in out.splitlines() if line.startswith("best ")] for out in (got, want)]
    assert best[0] == best[1] and len(best[0]) == 2 and best[0][0].startswith("best NDCG@10: ")
    pr, jr = json.loads((tmp_path / "port.json").read_text()), json.loads((tmp_path / "jax.json").read_text())
    assert pr["best_params"] == jr["best_params"] and abs(pr["best_value"] - jr["best_value"]) <= 1e-6
    assert [p["params"] for p in pr["points"]] == [p["params"] for p in jr["points"]]


def test_train_needs_the_card_unless_cpu(ml, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = CliRunner().invoke(cli, ["train", "-m", "bias", "-o", str(tmp_path / "m.pkl"), str(ml)])
    assert isinstance(res.exception, RuntimeError) and "CUDA" in str(res.exception)
    assert not (tmp_path / "m.pkl").exists()
    res = CliRunner().invoke(cli, ["train", "-m", "bias", "-o", str(tmp_path / "m.pkl"), str(ml)], env={"LKT_DEVICE": "cpu"}, auto_envvar_prefix="LKT")
    assert res.exit_code == 0, res.output
    assert (tmp_path / "m.pkl").exists()


def test_common_helpers():
    assert all(v.startswith("lkpy_tpu_torch.models.") for v in MODEL_REGISTRY.values())
    assert type(resolve_model("lkpy_tpu.models.bias:BiasScorer", {"damping": 2.0})).__module__ == "lkpy_tpu_torch.models.bias"
    assert parse_params(("a=1", "b=x", "c=[1, 2]", "d=true")) == {"a": 1, "b": "x", "c": [1, 2], "d": True}


def test_module_help_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "lkpy_tpu_torch", "--help"], cwd=ROOT, capture_output=True, text=True, timeout=240
    )
    assert proc.returncode == 0, proc.stderr
    assert "Usage:" in proc.stdout and "tune" in proc.stdout
    imported = {line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines() if line.startswith("import time:")}
    assert "lkpy_tpu_torch.cli" in imported
    assert not {m for m in imported if m.split(".")[0] in ("jax", "lkpy_tpu")}
