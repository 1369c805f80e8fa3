"""The port's LightGCN (``lkpy_tpu_torch.models.lightgcn``) against the JAX
package's on the CPU.

Both packages get the same synthetic interactions, made with numpy from a
seed (300 users × 180 items, 10 items without any user).  The trainers are
held epoch for epoch as in ``tests/test_torch_flexmf.py``: the port trainer
starts from the JAX trainer's initial tables, and both packages'
``sample_negatives`` are replaced by one deterministic function (fixed
candidates, the first that each package's exact CSR search finds no
interaction for).  The JAX package takes its scanned one-program step at
this size, the port its one step path.  Tolerances: the mean epoch losses
within rtol 1e-5, the tables within atol 1e-4 (Adam's division by the
running root mean square turns last-bit gradient differences near zero into
update differences of a few 1e-5; the tables are of order 0.1); the
propagated embeddings of ``finalize`` likewise; scores from the same tables
within rtol 1e-5; lists of pipelines trained in both packages within 1e-4
and equal wherever the gap to the next rank exceeds 1e-4.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu
import lkpy_tpu.models.lightgcn as jax_lightgcn
import lkpy_tpu_torch
import lkpy_tpu_torch.models.lightgcn as lightgcn
from lkpy_tpu.batch import recommend as jax_batch_recommend
from lkpy_tpu.data import DatasetBuilder as JaxBuilder
from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.ops import sampling as jax_sampling
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch import recommend
from lkpy_tpu_torch.batch.device import supports_device_batch
from lkpy_tpu_torch.data import ArrayTopNILC, DatasetBuilder, ItemList, Vocabulary
from lkpy_tpu_torch.models import LightGCNConfig, LightGCNScorer
from lkpy_tpu_torch.ops.sampling import csr_contains
from lkpy_tpu_torch.pipeline import Pipeline, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

N_USERS, N_ITEMS, EMPTY_ITEMS, K = 300, 180, 10, 8
UNKNOWN_USER, UNKNOWN_ITEM = 10_001, 99_999
CPU = TrainingOptions(rng=42, device="cpu")
COMMON = {"embedding_size": K, "batch_size": 256, "epochs": 2}
TABLE_TOL = 1e-4

VARIANTS = {
    "pairwise": {},
    "logistic": {"loss": "logistic"},
    "no-reg": {"regularization": None},
    "three-layers-blended": {"layer_count": 3, "layer_blend": [0.5, 0.3, 0.2]},
    "one-layer-float-blend": {"layer_count": 1, "layer_blend": 0.5},
}


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, size=N_USERS) + 3, 60)
    users = np.repeat(np.arange(N_USERS), lens)
    items = np.concatenate([rng.choice(N_ITEMS - EMPTY_ITEMS, size=n, replace=False) for n in lens])
    return pd.DataFrame({"user_id": users + 1, "item_id": items + 1})


def _dataset(builder_cls, df):
    dsb = builder_cls()
    dsb.add_entities("item", np.arange(1, N_ITEMS + 1))
    dsb.add_interactions("rating", df, entities=["user", "item"], missing="insert", default=True)
    return dsb.build()


@pytest.fixture(scope="module")
def data():
    df = _frame()
    return _dataset(JaxBuilder, df), _dataset(DatasetBuilder, df), df


def _candidates(xp, rows, n, n_cols):
    slot = xp.arange(n)[None, :, None]
    attempt = xp.arange(16)[None, None, :]
    return (rows[:, None, None] * 7 + slot * 13 + attempt * 31 + 3) % n_cols


def _jax_negatives(key, index, rows, *, n=1, weighting="uniform", max_attempts=16):
    cands = _candidates(jnp, rows, n, index.n_cols).astype(jnp.int32)
    bad = jax_sampling.csr_contains(index, jnp.broadcast_to(rows[:, None, None], cands.shape), cands)
    pick = jnp.where(jnp.any(~bad, axis=2), jnp.argmax(~bad, axis=2), 15)
    return jnp.take_along_axis(cands, pick[:, :, None], axis=2)[:, :, 0]


def _torch_negatives(generator, index, rows, *, n=1, weighting="uniform", max_attempts=16):
    cands = _candidates(torch, rows.long(), n, index.n_cols)
    bad = csr_contains(index, rows[:, None, None], cands)
    pick = torch.where(bad, 15, torch.arange(16)).amin(dim=2)
    return cands.gather(2, pick[:, :, None])[:, :, 0]


@pytest.fixture
def deterministic_negatives(monkeypatch):
    monkeypatch.setattr(jax_lightgcn, "sample_negatives", _jax_negatives)
    monkeypatch.setattr(lightgcn, "sample_negatives", _torch_negatives)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_epochs_match_jax(data, variant, deterministic_negatives):
    jds, tds, _ = data
    cfg = COMMON | VARIANTS[variant]
    js, ts = jax_lightgcn.LightGCNScorer(**cfg), LightGCNScorer(**cfg)
    jtr = js.create_trainer(jds, JaxTrainingOptions(rng=42))
    ttr = ts.create_trainer(tds, CPU)
    start = jtr.get_parameters()
    ttr.load_parameters(start)
    for epoch in (1, 2):
        want_loss = jtr.train_epoch()
        got_loss = ttr.train_epoch()
        assert got_loss == pytest.approx(want_loss, rel=1e-5)
        assert ttr.epochs_trained == jtr.epochs_trained == epoch
        got, want = ttr.get_parameters(), jtr.get_parameters()
        assert set(got) == set(want) == {"u_embed", "i_embed"}
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=TABLE_TOL, err_msg=f"{variant} {name} epoch {epoch}")
            assert not np.array_equal(got[name], start[name])
    jtr.finalize()
    ttr.finalize()
    for name in ("user_embeddings", "item_embeddings"):
        got = getattr(ts, name)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), getattr(js, name), rtol=0, atol=TABLE_TOL)


def test_configs_match_jax():
    for cfg in ({}, {"features": 32}, {"embedding_size_exp": 5}, {"layer_count": 3, "layer_blend": 0.25},
                {"layer_count": 2, "layer_blend": [0.6, 0.4]}, {"loss": "logistic", "regularization": None}):  # fmt: skip
        got, want = LightGCNConfig.model_validate(cfg), jax_lightgcn.LightGCNConfig.model_validate(cfg)
        assert got.model_dump() == want.model_dump()
        np.testing.assert_array_equal(got.blend_weights(), want.blend_weights())
    assert LightGCNConfig().embedding_size == 16
    with pytest.raises(ValueError):
        LightGCNConfig(layer_count=3, layer_blend=[0.5, 0.5])
    with pytest.raises(ValueError):
        jax_lightgcn.LightGCNConfig(layer_count=3, layer_blend=[0.5, 0.5])


def test_scores_from_jax_parameters_and_pickling(data):
    jds, tds, _ = data
    js = jax_lightgcn.LightGCNScorer(**COMMON)
    js.train(jds, JaxTrainingOptions(rng=42))
    ts = LightGCNScorer.from_numpy(js.get_parameters(), Vocabulary(js.users.ids, "user"), Vocabulary(js.items.ids, "item"), js.config.model_dump(), device="cpu")
    assert ts.is_trained and ts.item_embeddings.device.type == "cpu"
    rng = np.random.default_rng(3)
    for u in list(rng.choice(np.arange(1, N_USERS + 1), 10, replace=False)) + [UNKNOWN_USER]:
        cands = np.append(rng.choice(np.arange(1, N_ITEMS + 1), 50, replace=False), UNKNOWN_ITEM)
        got = ts(u, ItemList(item_ids=cands)).scores()
        want = js(u, JaxItemList(item_ids=cands)).scores()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert np.isnan(got[-1]) and np.isnan(got).all() == (u == UNKNOWN_USER)
    for name, arr in js.get_parameters().items():
        np.testing.assert_array_equal(ts.get_parameters()[name], arr)
    assert supports_device_batch(ts) and not supports_device_batch(LightGCNScorer())
    back = pickle.loads(pickle.dumps(ts))
    assert back.dump_config() == ts.dump_config()
    assert torch.equal(back.user_embeddings, ts.user_embeddings) and torch.equal(back.item_embeddings, ts.item_embeddings)


def _deterministic_tables(key, n_users, n_items, k, user_bias, item_bias, scale=0.1):
    rng = np.random.default_rng(n_users + 1000 * k)
    return {
        "u_embed": (rng.standard_normal((n_users, k)) * scale).astype(np.float32),
        "i_embed": (rng.standard_normal((n_items, k)) * scale).astype(np.float32),
    }


def test_topn_pipeline_recommend_matches_jax(data, deterministic_negatives, monkeypatch):
    """``topn_pipeline`` → ``Pipeline.train`` → ``batch.recommend`` on both
    routes, from the same initial tables in both packages."""
    jds, tds, df = data
    monkeypatch.setattr(jax_lightgcn, "init_params", lambda *a, **kw: {k: jnp.asarray(v) for k, v in _deterministic_tables(*a, **kw).items()})
    monkeypatch.setattr(lightgcn, "init_params", lambda *a, **kw: {k: torch.from_numpy(v) for k, v in _deterministic_tables(*a, **kw).items()})
    jp = lkpy_tpu.topn_pipeline(jax_lightgcn.LightGCNScorer(**COMMON), n=10)
    jp.train(jds, JaxTrainingOptions(rng=42))
    tp = topn_pipeline(LightGCNScorer(**COMMON), n=10)
    tp.train(tds, CPU)
    users = np.append(df["user_id"].unique()[:30], UNKNOWN_USER)
    want = jax_batch_recommend(jp, users, n=10)
    batch = recommend(tp, users, n=10)
    assert isinstance(batch, ArrayTopNILC)
    for got in (batch, recommend(tp, users, n=10, device=False)):
        for u in users:
            g, w = got.lookup(u), want.lookup(u)
            assert len(g) == len(w) == (0 if u == UNKNOWN_USER else 10)
            if not len(g):
                continue
            s = w.scores()
            np.testing.assert_allclose(g.scores(), s, rtol=1e-4, atol=1e-4)
            clear = np.ones(10, bool)
            gap = np.abs(np.diff(s)) > 1e-4
            clear[:-1] &= gap
            clear[1:] &= gap
            clear[-1] = False
            np.testing.assert_array_equal(np.asarray(g.ids())[clear], np.asarray(w.ids())[clear])
    again = Pipeline.from_config(tp.get_config())
    assert again.config_hash() == tp.config_hash()
    assert len(lkpy_tpu_torch.recommend(tp, users[0], n=10)) == 10


def test_runs_on_the_card_unless_told_cpu(data, monkeypatch):
    _, tds, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LightGCNScorer(**COMMON).train(tds, TrainingOptions())
    with pytest.raises(RuntimeError, match="CUDA"):
        LightGCNScorer.from_numpy({"user_embeddings": np.zeros((2, 2)), "item_embeddings": np.zeros((2, 2))}, Vocabulary([1, 2]), Vocabulary([1, 2]))
