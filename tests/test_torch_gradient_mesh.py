"""The gradient family on the mesh (``lkpy_tpu_torch.parallel.gradient``, the
``mesh`` branches of FlexMF and LightGCN) against the JAX package's on the
CPU.

The JAX side runs on the 8-device virtual CPU mesh that ``conftest.py``
sets up, as a (4, 2) mesh; the port runs a (4, 2) mesh of ``cpu`` slots.
Both get the JAX sharding test's set (``tests/parallel/
test_gradient_sharding.py``: 200 users × 300 items from 5,000 draws, seed
1234) and its configurations.  Each JAX trainer runs once per module (a
module-scope fixture) with its initial tables recorded.

Tolerances:
- the port sharded against the port unsharded from the same seed: losses
  within rtol 1e-6 and tables within atol 1e-5.  Both draw the same
  initial tables and negatives and take the same examples; only the sums
  differ in order (each ``data`` slot sums its block, the parts are added
  on the first slot, and each shard accumulates its rows' gradients
  apart), which moved the tables by at most 9.0e-7 (the convolution
  preset; 3.7e-7 for BPR) and the losses by 1.4e-7 relative in the runs
  behind this file.  Adam's division by the running root mean square can magnify a
  last-bit difference in a gradient near zero (``test_torch_flexmf.py``
  saw up to 3.5e-5 across packages), hence the margin.
- the port sharded against the JAX package's sharded trainer, from the JAX
  trainer's initial tables with both packages' ``sample_negatives``
  replaced by one deterministic function (``test_torch_flexmf.py``'s): the
  losses within rtol 1e-5, the tables within atol 1e-4 and rtol 1e-4, as
  in ``test_torch_flexmf.py``.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu.models.flexmf as jax_flexmf
import lkpy_tpu.models.lightgcn as jax_lightgcn
import lkpy_tpu_torch.models.flexmf as flexmf
import lkpy_tpu_torch.models.lightgcn as lightgcn
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.parallel import MeshSpec as JaxMeshSpec
from lkpy_tpu.parallel import make_mesh as jax_make_mesh
from lkpy_tpu.parallel.gradient import table_rows as jax_table_rows
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.parallel import MeshSpec, make_mesh
from lkpy_tpu_torch.parallel.dryrun import dryrun_multichip
from lkpy_tpu_torch.parallel.gradient import batch_sharding, leaf_sharding, place_tree, table_rows, take_rows
from lkpy_tpu_torch.parallel.ops import Sharded
from lkpy_tpu_torch.training import TrainingOptions
from tests.test_torch_flexmf import _jax_negatives, _torch_negatives

torch.set_num_threads(1)

#: the JAX sharding test's configurations (tests/parallel/test_gradient_sharding.py:52-88)
VARIANTS = {
    "bpr": ("implicit", {"features": 16, "epochs": 2, "loss": "pairwise", "batch_size": 1024}),
    "warp": ("implicit", {"features": 16, "epochs": 1, "loss": "warp", "batch_size": 1024, "warp_candidates": 16}),
    "explicit": ("explicit", {"features": 16, "epochs": 2, "batch_size": 1024}),
    "lightgcn": ("lightgcn", {"embedding_size": 8, "epochs": 2, "batch_size": 1024, "layer_count": 1}),
    # a batch that the 4 data slots do not divide: both packages round it to 1000
    "bpr-1001": ("implicit", {"features": 16, "epochs": 2, "loss": "pairwise", "batch_size": 1001}),
}
SEED = 42


def _classes(kind):
    return {
        "implicit": (jax_flexmf.FlexMFImplicitScorer, flexmf.FlexMFImplicitScorer),
        "explicit": (jax_flexmf.FlexMFExplicitScorer, flexmf.FlexMFExplicitScorer),
        "lightgcn": (jax_lightgcn.LightGCNScorer, lightgcn.LightGCNScorer),
    }[kind]


def _frame():
    rng = np.random.default_rng(1234)
    n_users, n_items, n_draw = 200, 300, 5000
    i_w = 1.0 / np.arange(1, n_items + 1) ** 0.7
    return pd.DataFrame(
        {
            "user_id": rng.integers(0, n_users, n_draw),
            "item_id": rng.choice(n_items, n_draw, p=i_w / i_w.sum()),
            "rating": rng.integers(1, 6, n_draw).astype(np.float32),
        }
    ).drop_duplicates(["user_id", "item_id"])


@pytest.fixture(scope="module")
def data():
    df = _frame()
    return jax_from_df(df), from_interactions_df(df)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8, "tests need the 8-device virtual CPU mesh"
    return jax_make_mesh(JaxMeshSpec(data=4, model=2))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshSpec(data=4, model=2), devices=["cpu"] * 8)


def _trainer(cls, cfg, ds, options):
    return cls(cls.validate_config(cfg)).create_trainer(ds, options)


@pytest.fixture(scope="module")
def jax_runs(data, jax_mesh):
    """Each variant's JAX sharded trainer under the deterministic sampler:
    its initial tables, then the loss and tables after each epoch."""
    jds, _ = data
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_flexmf, "sample_negatives", _jax_negatives)
        mp.setattr(jax_lightgcn, "sample_negatives", _jax_negatives)
        for name, (kind, cfg) in VARIANTS.items():
            tr = _trainer(_classes(kind)[0], cfg, jds, JaxTrainingOptions(rng=SEED, mesh=jax_mesh))
            run = {"start": tr.get_parameters(), "epochs": []}
            for _ in range(cfg["epochs"]):
                loss = tr.train_epoch()
                run["epochs"].append((loss, tr.get_parameters()))
            out[name] = run
    return out


@pytest.fixture
def deterministic_negatives(monkeypatch):
    monkeypatch.setattr(flexmf, "sample_negatives", _torch_negatives)
    monkeypatch.setattr(lightgcn, "sample_negatives", _torch_negatives)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_matches_jax_sharded(data, mesh, jax_runs, variant, deterministic_negatives):
    _, tds = data
    kind, cfg = VARIANTS[variant]
    run = jax_runs[variant]
    tr = _trainer(_classes(kind)[1], cfg, tds, TrainingOptions(rng=SEED, mesh=mesh))
    tr.load_parameters(run["start"])
    assert all(isinstance(v, Sharded) for v in tr.params.values())
    for epoch, (want_loss, want) in enumerate(run["epochs"], 1):
        got_loss = tr.train_epoch()
        assert got_loss == pytest.approx(want_loss, rel=1e-5)
        got = tr.get_parameters()
        assert set(got) == set(want)
        for name in want:
            assert got[name].shape == want[name].shape
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-4, err_msg=f"{variant} {name} epoch {epoch}")
            assert not np.array_equal(got[name], run["start"][name])


@pytest.mark.parametrize("variant", ["bpr", "warp", "explicit", "lightgcn", "logistic", "flexmf-conv"])
def test_sharded_matches_unsharded(data, mesh, variant):
    """Trained through ``Scorer.train`` from the same seed: the sharded run
    draws the same tables and negatives as the unsharded one."""
    _, tds = data
    kind, cfg = VARIANTS.get(variant) or {
        "logistic": ("implicit", {"features": 16, "epochs": 2, "batch_size": 1000}),
        "flexmf-conv": ("implicit", {"features": 16, "epochs": 2, "preset": "lightgcn", "batch_size": 1000}),
    }[variant]
    cls = _classes(kind)[1]
    single = _trainer(cls, cfg, tds, TrainingOptions(rng=SEED, device="cpu"))
    sharded = _trainer(cls, cfg, tds, TrainingOptions(rng=SEED, mesh=mesh))
    want, got = single.get_parameters(), sharded.get_parameters()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    for _ in range(cfg["epochs"]):
        assert sharded.train_epoch() == pytest.approx(single.train_epoch(), rel=1e-6)
    want, got = single.get_parameters(), sharded.get_parameters()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5, err_msg=f"{variant} {name}")
    single.finalize()
    sharded.finalize()
    if kind == "lightgcn":
        pairs = [(sharded.component.user_embeddings, single.component.user_embeddings), (sharded.component.item_embeddings, single.component.item_embeddings)]
    else:
        pairs = [(sharded.component.params[k], single.component.params[k]) for k in single.component.params]
    for got_t, want_t in pairs:
        # whole tables on the first slot, served as without a mesh
        assert isinstance(got_t, torch.Tensor) and got_t.device == mesh.first and got_t.shape == want_t.shape
        np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), rtol=0, atol=1e-5)


def test_tables_sharded_and_batches_split(data, mesh, monkeypatch):
    """Each table lies in ⌈n/m⌉-row blocks, one on each ``model`` slot, and
    each step's batch reaches the loss as one block a ``data`` slot."""
    _, tds = data
    tr = _trainer(flexmf.FlexMFImplicitScorer, {"features": 16, "epochs": 1, "user_bias": True}, tds, TrainingOptions(rng=0, mesh=mesh))
    blocks = []
    orig = tr.block_loss

    def recording(embeds, rows, *block):
        blocks.append((rows, [tuple(c.shape) for c in block], [c.device for c in block]))
        return orig(embeds, rows, *block)

    monkeypatch.setattr(tr, "block_loss", recording)
    tr.train_epoch()
    m = mesh.shape["model"]
    for name, table in tr.params.items():
        n = tds.user_count if name.startswith("u_") else tds.item_count
        assert isinstance(table, Sharded) and table.axis == "model"
        per = -(-n // m)
        assert [p.shape[0] for p in table.parts] == [min(per, n - s * per) for s in range(m)]
        assert [p.device for p in table.parts] == mesh.axis_devices("model")
        assert all(p.is_leaf and p.requires_grad for p in table.parts)
        assert table_rows(n, mesh) == jax_table_rows(n, _JaxShape(m)) == per * m
    d = mesh.shape["data"]
    n = tds.interaction_count
    bs = min(tr.config.batch_size, n)
    bs -= bs % d  # 4429 examples: a batch of 4428 and a padded second one
    steps = -(-n // bs)
    assert len(blocks) == steps * d
    for rows, shapes, devs in blocks:
        assert rows == bs and all(s[0] == bs // d for s in shapes)
    assert [b[2][0] for b in blocks[:d]] == mesh.axis_devices("data")
    # the optimizer steps every shard leaf
    assert {id(p) for g in tr.opt.param_groups for p in g["params"]} == {id(p) for t in tr.params.values() for p in t.parts}


class _JaxShape:
    """The ``shape`` mapping that the JAX ``table_rows`` reads of a mesh."""

    def __init__(self, m):
        self.shape = {"model": m}


def test_gradient_helpers(mesh):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((11, 4)).astype(np.float32))
    placed = place_tree(mesh, {"t": table, "b": table[:, 0], "scalar": torch.tensor(2.0)}, {11})
    assert leaf_sharding(mesh, table, {11}) == "model" and leaf_sharding(mesh, torch.tensor(2.0), {11}) is None
    assert isinstance(placed["scalar"], torch.Tensor) and placed["scalar"].requires_grad
    assert [p.shape[0] for p in placed["t"].parts] == [6, 5]
    idx = torch.from_numpy(rng.integers(0, 11, (7, 3)))
    got = take_rows(placed["t"], idx)
    np.testing.assert_array_equal(got.detach().numpy(), table[idx].numpy())
    np.testing.assert_array_equal(take_rows(placed["b"], idx).detach().numpy(), table[idx, 0].numpy())
    w = torch.from_numpy(rng.standard_normal((7, 3, 4)).astype(np.float32))
    (got * w).sum().backward()
    want = torch.zeros_like(table).index_put_((idx.reshape(-1),), w.reshape(-1, 4), accumulate=True)
    np.testing.assert_allclose(torch.cat([p.grad for p in placed["t"].parts]).numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    cols = batch_sharding(mesh, torch.arange(12), torch.arange(12) * 2)
    assert [tuple(c[0].tolist()) for c in cols] == [(0, 1, 2), (3, 4, 5), (6, 7, 8), (9, 10, 11)]
    assert [tuple(c[1].tolist()) for c in cols] == [(0, 2, 4), (6, 8, 10), (12, 14, 16), (18, 20, 22)]
    assert table_rows(11, mesh) == jax_table_rows(11, _JaxShape(2)) == 12 and table_rows(11, None) == 11


@pytest.mark.parametrize("kind", ["implicit", "lightgcn"])
def test_checkpoint_crosses_sharded_and_single(data, mesh, kind):
    """``get_parameters`` gives whole, unpadded tables; ``load_parameters``
    places them on the shards, or whole, either way round."""
    _, tds = data
    cls = _classes(kind)[1]
    cfg = {"features": 16, "epochs": 1} if kind == "implicit" else {"embedding_size": 8, "epochs": 1}
    t1 = _trainer(cls, cfg, tds, TrainingOptions(rng=0, device="cpu"))
    t1.train_epoch()
    state = t1.get_parameters()
    assert state["i_embed"].shape[0] == tds.item_count and state["u_embed"].shape[0] == tds.user_count
    t2 = _trainer(cls, cfg, tds, TrainingOptions(rng=1, mesh=mesh))
    t2.load_parameters(state)
    assert all(isinstance(v, Sharded) for v in t2.params.values())
    out = t2.get_parameters()
    for name in state:
        np.testing.assert_array_equal(out[name], state[name])
    t2.train_epoch()
    back = _trainer(cls, cfg, tds, TrainingOptions(rng=2, device="cpu"))
    back.load_parameters(t2.get_parameters())
    for name, v in back.get_parameters().items():
        np.testing.assert_array_equal(v, t2.get_parameters()[name])
        assert not np.array_equal(v, state[name])


def test_dryrun_runs_every_part():
    line = dryrun_multichip(8, device="cpu")
    for part in (
        "sharded ALS epoch == single-device",
        "sharded kNN build == single-device",
        "distributed recommend == single-device",
        "sharded FlexMF-BPR == single-device",
        "sharded LightGCN step ok",
        "topk ok",
    ):
        assert part in line
