"""The port's multi-process layer on the CPU: ``init_distributed`` on one
host, ``distributed_recommend`` over two gloo processes against the
single-process lists (the port of ``tests/parallel/test_two_process.py``),
the log relay between a parent and a child, and the imports of the
multi-device modules.

Run as a script, this file is the two-process test's worker:
``python test_torch_distributed.py RANK WORLD PORT DIR``.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

REPO = Path(__file__).resolve().parents[1]
N_FEATURES = 8
N_LIST = 5


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(REPO) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(procs: list, timeout: float = 120) -> list[str]:
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _dataset():
    from lkpy_tpu_torch.data import from_interactions_df

    rng = np.random.default_rng(4242)
    n_users, n_items, n_draw = 120, 80, 3000
    df = pd.DataFrame(
        {"user_id": rng.integers(0, n_users, n_draw), "item_id": rng.integers(0, n_items, n_draw)}
    ).drop_duplicates(["user_id", "item_id"])
    return from_interactions_df(df)


def _serving_scorer(ds, params: Path):
    """The trained tables loaded through ``state.load_parameters``, with the
    fold-in's YᵀY + λI made as the trainer makes it."""
    import torch

    from lkpy_tpu_torch import state
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.ops.als import implicit_otor

    torch.set_num_threads(1)
    scorer = ImplicitMFScorer(features=N_FEATURES, user_embeddings=True)
    state.load_parameters(scorer, params, device="cpu")
    scorer.users, scorer.items = ds.users, ds.items
    scorer._OtOr = implicit_otor(scorer.item_embeddings, scorer.config.user_reg)
    return scorer


def _worker(rank: int, world: int, port: int, outdir: Path) -> None:
    from lkpy_tpu_torch.batch.distributed import distributed_recommend, local_query_shard
    from lkpy_tpu_torch.data import Dataset
    from lkpy_tpu_torch.logging.multiprocess import get_monitor
    from lkpy_tpu_torch.parallel import host_count, init_distributed, is_coordinator
    from lkpy_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    if not init_distributed(f"127.0.0.1:{port}", world, rank):
        raise AssertionError("the process group did not start")
    assert host_count() == world and is_coordinator() == (rank == 0)
    relayed: list[str] = []
    if rank == 0:

        class Collect(logging.Handler):
            def emit(self, record):
                relayed.append(record.getMessage())

        logging.getLogger("lkt.relay_check").addHandler(Collect())
        logging.getLogger("lkt.relay_check").setLevel(logging.INFO)
        assert get_monitor() is not None
    ds = Dataset.load(outdir / "data")
    scorer = _serving_scorer(ds, outdir / "params.npz")
    users = ds.users.ids
    local = local_query_shard(users)
    assert 0 < len(local) < len(users)
    if rank != 0:
        logging.getLogger("lkt.relay_check").warning("rank %d serves %d users", rank, len(local))
    mesh = make_mesh(MeshSpec(data=2), devices=["cpu", "cpu"])
    merged = distributed_recommend(scorer, users, N_LIST, ds.interaction_matrix(), mesh=mesh, chunk=16)
    if rank == 0:
        assert merged is not None
        deadline = time.monotonic() + 30
        while not relayed and time.monotonic() < deadline:
            time.sleep(0.05)
        out = {"lists": {str(key[0]): [int(i) for i in il.ids()] for key, il in merged.items()}, "relayed": relayed}
        (outdir / "result.json").write_text(json.dumps(out))
    else:
        assert merged is None
        (outdir / f"worker{rank}.ok").write_text("ok")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lkpy_tpu", "zmq"))
    if bad:
        raise AssertionError(f"the worker imported {bad}")


def test_init_distributed_is_a_no_op_on_one_host(monkeypatch):
    from lkpy_tpu_torch.parallel import distributed

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.init_distributed() is False
    assert distributed.is_coordinator()
    assert distributed.host_count() == 1 and distributed.host_index() == 0
    assert distributed.local_device_count() == 0  # no card here
    assert distributed.setup_log_relay("tcp://127.0.0.1:1", "00") is None  # single-process


def test_one_process_query_shard_and_gather_are_the_identity():
    from lkpy_tpu_torch.batch.distributed import gather_results, local_query_shard
    from lkpy_tpu_torch.data import ItemList, ItemListCollection

    users = np.arange(11)
    np.testing.assert_array_equal(local_query_shard(users), users)
    ilc = ItemListCollection(["user_id"])
    ilc.add(ItemList(item_ids=[1, 2]), 3)
    assert gather_results(ilc, ("user_id",)) is ilc


def test_two_process_distributed_recommend(tmp_path):
    import torch

    from lkpy_tpu_torch import state
    from lkpy_tpu_torch.batch.device import device_recommend
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.training import TrainingOptions

    torch.set_num_threads(1)
    ds = _dataset()
    trained = ImplicitMFScorer(features=N_FEATURES, epochs=2)
    trained.train(ds, TrainingOptions(rng=42, device="cpu"))
    ds.save(tmp_path / "data")
    state.save_parameters(trained, tmp_path / "params.npz")

    env = _env()
    env["LKT_LOG_RELAY"] = f"tcp://127.0.0.1:{_free_port()}"
    env["LKT_LOG_RELAY_KEY"] = os.urandom(16).hex()
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(rank), "2", str(port), str(tmp_path)],
            env=env,
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(2)
    ]
    outs = _run(procs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert (tmp_path / "worker1.ok").exists()
    result = json.loads((tmp_path / "result.json").read_text())
    # the relay carried rank 1's record to rank 0
    assert any(m.startswith("[worker ") and "rank 1 serves" in m for m in result["relayed"]), result["relayed"]

    want = device_recommend(_serving_scorer(ds, tmp_path / "params.npz"), ds.users.ids, N_LIST, ds.interaction_matrix(), device="cpu")
    assert len(result["lists"]) == len(want) == ds.user_count
    for key, il in want.items():
        assert result["lists"][str(key[0])] == [int(i) for i in il.ids()], key


_CHILD = """
import logging, sys
from lkpy_tpu_torch.logging.multiprocess import WorkerContext
address, key = sys.argv[1], bytes.fromhex(sys.argv[2])
forged = WorkerContext(address, b"not the key")
forged.send_record({"forged": True})
forged.close()
ctx = WorkerContext(address, key)
ctx.send_record({"step": 3, "loss": 0.5})
ctx.install_handler()
logging.getLogger("lkt.child").warning("hello from %s", "the child")
ctx.close()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "zmq", "lkpy_tpu"))
assert not bad, bad
"""


@pytest.mark.parametrize("transport", ["tcp", "ipc"])
def test_log_relay_between_a_parent_and_a_child(tmp_path, transport):
    from lkpy_tpu_torch.logging.multiprocess import Monitor

    address = None if transport == "tcp" else f"ipc://{tmp_path}/relay.sock"
    monitor = Monitor(address)
    records, messages = [], []

    class Sink:
        def record(self, data):
            records.append(data)

    class Collect(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler = Collect()
    logging.getLogger("lkt.child").addHandler(handler)
    monitor.add_record_sink(Sink(), "sink")
    try:
        assert monitor.address.startswith(f"{transport}://")
        child = subprocess.Popen(
            [sys.executable, "-c", _CHILD, monitor.address, monitor.auth_key.hex()],
            env=_env(),
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        (out,) = _run([child], timeout=60)
        assert child.returncode == 0, out
        deadline = time.monotonic() + 10
        while (not records or not messages) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        logging.getLogger("lkt.child").removeHandler(handler)
        monitor.shutdown()
    assert records == [{"step": 3, "loss": 0.5}]  # the forged record was dropped
    assert len(messages) == 1 and messages[0].endswith("] hello from the child") and messages[0].startswith("[worker ")


def test_relay_addresses_are_checked():
    from lkpy_tpu_torch.logging.multiprocess import Monitor

    for bad in ("udp://x:1", "tcp://nohost", "tcp://h:port"):
        with pytest.raises(ValueError):
            Monitor(bad)


def test_multi_device_modules_import_no_jax_or_zmq():
    code = """
import importlib, pkgutil, sys
import lkpy_tpu_torch
for name in ("lkpy_tpu_torch.parallel", "lkpy_tpu_torch.parallel.als", "lkpy_tpu_torch.parallel.knn",
             "lkpy_tpu_torch.parallel.dryrun", "lkpy_tpu_torch.parallel.gradient", "lkpy_tpu_torch.batch.distributed",
             "lkpy_tpu_torch.logging.multiprocess"):
    importlib.import_module(name)
for m in pkgutil.walk_packages(lkpy_tpu_torch.__path__, "lkpy_tpu_torch."):
    importlib.import_module(m.name)
print(",".join(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lkpy_tpu", "zmq"))))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the port loaded {out.stdout.strip()}"


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
