"""BENCHMARK.json against the contract's shape, and the harness's discovery
of configurations, mixes and metrics by name."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from portbench.core.cell import cell_metrics, load_benchmark, load_reader, run_cell
from tiny import TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_keys_and_names():
    b = load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        e2e, layer = cell_metrics(b, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES and m["moves"] in moves
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]])
def test_every_reader_loads_by_name(name):
    assert callable(load_reader(name).read)


def test_a_new_metric_file_is_read_without_editing_the_harness(tmp_path):
    """A copy of the benchmark with one more per-layer metric: its reader
    file and its entry alone make it appear in a traced run's line."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = load_benchmark()
    bench["per_layer"].append(
        {"name": "test.extra", "unit": "count", "better": "higher", "source": "host_clock", "layer": "device",
         "moves": "serve_users_per_s", "workloads": ["als-implicit-ml20m.serve"]}
    )
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "metrics" / "test.extra.py").write_text("def read(r):\n    return float(r.counters['requests'])\n")
    res = run_cell("als-implicit-ml20m.serve", 7, 1.0, True, torch.device("cpu"), t_start=time.perf_counter(), root=tmp_path, overrides=TINY)
    assert res["metrics"]["test.extra"]["value"] == res["attempted"] > 0


def test_run_refuses_without_a_card():
    """Without a card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "als-implicit-ml20m.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and "{" not in proc.stdout


def test_run_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/ no result is printed."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "als-implicit-ml20m.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and "{" not in proc.stdout
