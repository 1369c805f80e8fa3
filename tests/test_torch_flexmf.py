"""The port's FlexMF family (``lkpy_tpu_torch.models.flexmf``) against the JAX
package's on the CPU.

Both packages get the same synthetic interactions with ratings, made with
numpy from a seed (300 users × 180 items, 10 items without any user).
The trainers are held epoch for epoch: each port trainer starts from the
JAX trainer's initial tables, and both packages' ``sample_negatives`` are
replaced by one deterministic function of the batch's users (fixed
candidates, the first that each package's exact CSR search finds no
interaction for), so the two take the same examples in the same order
(the permutation comes from the same NumPy generator) with the same
negatives.

Tolerances: the mean epoch losses within rtol 1e-5; the tables within
atol 1e-4 after each epoch (Adam divides each gradient by its running root
mean square, so a last-bit difference in a gradient near zero moves an
update by up to a few 1e-5, 3.5e-5 the most seen here; the tables are of
order 0.1, one step's update up to 0.01, and a flipped WARP choice parts
them by 1e-3 or more); model scores within 1e-6; scores from the same
tables within rtol 1e-5; lists of pipelines trained in both packages
within 1e-4 and equal wherever the gap to the next rank exceeds 1e-4.

WARP's choices agree only while no margin that decides one lies within
the two packages' rounding, so the WARP case asserts that every such
margin exceeds 1e-5.  Its training seed is 46: of the seeds 42 to 59 it is
the only one whose two epochs meet no margin under 1e-5 (16 met one or
more, down to 1.3e-7; at 42, 48 and 54 a margin of 2.5e-7 to 9.1e-7
flipped a choice and the tables parted by 1e-3 to 1e-2; at the other 13
they still agreed within 3e-5).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu
import lkpy_tpu.models.flexmf as jax_flexmf
import lkpy_tpu_torch
import lkpy_tpu_torch.models.flexmf as flexmf
from lkpy_tpu.batch import recommend as jax_batch_recommend
from lkpy_tpu.batch.device import device_recommend as jax_device_recommend
from lkpy_tpu.data import DatasetBuilder as JaxBuilder
from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.ops import sampling as jax_sampling
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch import recommend
from lkpy_tpu_torch.batch.device import device_recommend, supports_device_batch
from lkpy_tpu_torch.data import ArrayTopNILC, DatasetBuilder, ItemList, Vocabulary
from lkpy_tpu_torch.models import FlexMFExplicitScorer, FlexMFImplicitScorer
from lkpy_tpu_torch.models.flexmf import FlexMFExplicitConfig, FlexMFImplicitConfig, model_scores
from lkpy_tpu_torch.ops.sampling import csr_contains
from lkpy_tpu_torch.pipeline import Pipeline, predict_pipeline, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

N_USERS, N_ITEMS, EMPTY_ITEMS, K = 300, 180, 10, 8
UNKNOWN_USER, UNKNOWN_ITEM = 10_001, 99_999
CPU = TrainingOptions(rng=42, device="cpu")
MARGIN = 1e-5

#: the trainers held epoch for epoch (scorer class name, config)
VARIANTS = {
    "explicit": ("explicit", {}),
    "logistic": ("implicit", {}),
    "bpr": ("implicit", {"preset": "bpr"}),
    "bpr-l2": ("implicit", {"preset": "bpr", "reg_method": "L2"}),
    "warp": ("implicit", {"preset": "warp", "warp_candidates": 8}),
    "popular": ("implicit", {"negative_strategy": "popular", "negative_count": 3}),
    "lightgcn": ("implicit", {"preset": "lightgcn", "convolution_layers": 2}),
}
COMMON = {"embedding_size": K, "batch_size": 256, "epochs": 2}
WARP_SEED = 46
TABLE_TOL = 1e-4


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, size=N_USERS) + 3, 60)
    users = np.repeat(np.arange(N_USERS), lens)
    items = np.concatenate([rng.choice(N_ITEMS - EMPTY_ITEMS, size=n, replace=False) for n in lens])
    ratings = (rng.integers(1, 11, size=len(users)) / 2.0).astype(np.float32)
    return pd.DataFrame({"user_id": users + 1, "item_id": items + 1, "rating": ratings})


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
    """16 deterministic candidates for each of the ``n`` slots of each row."""
    slot = xp.arange(n)[None, :, None]
    attempt = xp.arange(16)[None, None, :]
    return (rows[:, None, None] * 7 + slot * 13 + attempt * 31 + 3) % n_cols


def _jax_negatives(key, index, rows, *, n=1, weighting="uniform", max_attempts=16):
    """Each slot's first candidate that the exact CSR search finds no
    interaction for (the JAX package's own search)."""
    cands = _candidates(jnp, rows, n, index.n_cols).astype(jnp.int32)
    bad = jax_sampling.csr_contains(index, jnp.broadcast_to(rows[:, None, None], cands.shape), cands)
    pick = jnp.where(jnp.any(~bad, axis=2), jnp.argmax(~bad, axis=2), 15)
    return jnp.take_along_axis(cands, pick[:, :, None], axis=2)[:, :, 0]


def _torch_negatives(generator, index, rows, *, n=1, weighting="uniform", max_attempts=16):
    """:func:`_jax_negatives` with the port's own search."""
    cands = _candidates(torch, rows.long(), n, index.n_cols)
    bad = csr_contains(index, rows[:, None, None], cands)
    pick = torch.where(bad, 15, torch.arange(16)).amin(dim=2)
    return cands.gather(2, pick[:, :, None])[:, :, 0]


@pytest.fixture
def deterministic_negatives(monkeypatch):
    monkeypatch.setattr(jax_flexmf, "sample_negatives", _jax_negatives)
    monkeypatch.setattr(flexmf, "sample_negatives", _torch_negatives)


def _scorers(kind, cfg):
    cfg = COMMON | cfg
    if kind == "explicit":
        return jax_flexmf.FlexMFExplicitScorer(**cfg), FlexMFExplicitScorer(**cfg)
    return jax_flexmf.FlexMFImplicitScorer(**cfg), FlexMFImplicitScorer(**cfg)


def _warp_margins(monkeypatch) -> list:
    """Record, for every WARP choice, the least margin that decides it: the
    gaps to the positive of every candidate up to the first one above it
    (all of them when none is), and the gap between the two best when none
    is (the fallback's argmax)."""
    margins = []
    orig = flexmf.warp_negatives

    def recording(cand_scores, cand_norms, pos_pred, n_items):
        with torch.no_grad():
            d = cand_scores - pos_pred[:, None]
            better = d > 0
            C = d.shape[1]
            first = torch.where(better, torch.arange(C), C - 1).amin(dim=1)
            upto = torch.arange(C)[None, :] <= first[:, None]
            m = torch.where(upto, d.abs(), torch.inf).amin(dim=1)
            top2 = cand_scores.topk(2, dim=1).values
            m = torch.where(better.any(dim=1), m, torch.minimum(m, top2[:, 0] - top2[:, 1]))
            margins.append(float(m.min()))
        return orig(cand_scores, cand_norms, pos_pred, n_items)

    monkeypatch.setattr(flexmf, "warp_negatives", recording)
    return margins


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_epochs_match_jax(data, variant, deterministic_negatives, monkeypatch):
    jds, tds, _ = data
    kind, cfg = VARIANTS[variant]
    js, ts = _scorers(kind, cfg)
    margins = _warp_margins(monkeypatch)
    seed = WARP_SEED if variant == "warp" else 42
    jtr = js.create_trainer(jds, JaxTrainingOptions(rng=seed))
    ttr = ts.create_trainer(tds, TrainingOptions(rng=seed, device="cpu"))
    start = jtr.get_parameters()
    ttr.load_parameters(start)
    assert set(ttr.get_parameters()) == set(start)
    for epoch in (1, 2):
        want_loss = jtr.train_epoch()
        got_loss = ttr.train_epoch()
        assert got_loss == pytest.approx(want_loss, rel=1e-5)
        assert ttr.epochs_trained == jtr.epochs_trained == epoch
        got, want = ttr.get_parameters(), jtr.get_parameters()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=TABLE_TOL, err_msg=f"{variant} {name} epoch {epoch}")
            assert not np.array_equal(got[name], start[name])
    if variant == "warp":
        assert len(margins) == 2 * -(-len(jtr._users) // COMMON["batch_size"])
        assert min(margins) > MARGIN, f"a WARP choice decided by a margin of {min(margins):.2e}"
    # finalize: the tables (propagated for the convolution preset) on the scorer
    jtr.finalize()
    ttr.finalize()
    assert ts.is_trained
    for name, want in js.params.items():
        got = ts.params[name]
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TABLE_TOL)
    if kind == "explicit":
        assert ts.global_bias == js.global_bias


def test_configs_match_jax():
    assert flexmf.PRESETS == jax_flexmf.PRESETS
    for cfg in ({}, {"preset": "bpr"}, {"preset": "warp"}, {"preset": "lightgcn"}, {"features": 16},
                {"embedding_size_exp": 5}, {"preset": "lightgcn", "convolution_layers": 3}, {"loss": "warp", "negative_strategy": "misranked"}):  # fmt: skip
        got, want = FlexMFImplicitConfig.model_validate(cfg), jax_flexmf.FlexMFImplicitConfig.model_validate(cfg)
        assert got.model_dump() == want.model_dump()
        assert got.selected_negative_strategy() == want.selected_negative_strategy()
    for cfg in ({}, {"features": 12}, {"embedding_size_exp": 3}, {"reg_method": "AdamW"}):
        assert FlexMFExplicitConfig.model_validate(cfg).model_dump() == jax_flexmf.FlexMFExplicitConfig.model_validate(cfg).model_dump()
    assert FlexMFImplicitConfig().embedding_size == 64 and FlexMFImplicitConfig(embedding_size_exp=5).embedding_size == 32
    assert FlexMFExplicitScorer(features=7).dump_config() == jax_flexmf.FlexMFExplicitScorer(features=7).dump_config()
    for bad in ({"preset": "nope"}, {"loss": "warp", "negative_strategy": "uniform"}, {"negative_strategy": "misranked", "negative_count": 2}):
        with pytest.raises(ValueError):
            FlexMFImplicitConfig.model_validate(bad)
        with pytest.raises(ValueError):
            jax_flexmf.FlexMFImplicitConfig.model_validate(bad)


@pytest.mark.parametrize("biases", [(), ("u_bias",), ("i_bias",), ("u_bias", "i_bias")])
@pytest.mark.parametrize("wide", [False, True])
def test_model_scores_match_jax(biases, wide):
    rng = np.random.default_rng(5)
    params = {"u_embed": rng.standard_normal((40, K)), "i_embed": rng.standard_normal((30, K))}
    if "u_bias" in biases:
        params["u_bias"] = rng.standard_normal(40)
    if "i_bias" in biases:
        params["i_bias"] = rng.standard_normal(30)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    users = rng.integers(0, 40, 64).astype(np.int32)
    items = rng.integers(0, 30, (64, 5) if wide else 64).astype(np.int32)
    embeds = {k: torch.from_numpy(v) for k, v in params.items()}
    got = model_scores(embeds, torch.from_numpy(users), torch.from_numpy(items))
    want = jax_flexmf.model_scores({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(users), jnp.asarray(items))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    # the propagated tables in place of the parameters' own
    swapped = model_scores(embeds, torch.from_numpy(users), torch.from_numpy(items), embeds=(embeds["u_embed"] * 2, embeds["i_embed"]))
    want2 = jax_flexmf.model_scores(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(users), jnp.asarray(items),
        embeds=(jnp.asarray(params["u_embed"]) * 2, jnp.asarray(params["i_embed"])),
    )  # fmt: skip
    np.testing.assert_allclose(swapped[0].numpy(), np.asarray(want2[0]), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def trained(data):
    """JAX scorers trained for two epochs with their own samplers."""
    jds, _, _ = data
    out = {}
    for kind, cfg in (("explicit", {}), ("implicit", {"preset": "bpr", "user_bias": True})):
        js = _scorers(kind, cfg)[0]
        js.train(jds, JaxTrainingOptions(rng=42))
        out[kind] = js
    return out


@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_scores_from_jax_parameters(data, trained, kind):
    jds, tds, _ = data
    js = trained[kind]
    cls = FlexMFExplicitScorer if kind == "explicit" else FlexMFImplicitScorer
    extra = (js.global_bias,) if kind == "explicit" else ()
    ts = cls.from_numpy(js.get_parameters(), Vocabulary(js.users.ids, "user"), Vocabulary(js.items.ids, "item"), js.config.model_dump(), *extra, device="cpu")
    assert set(ts.params) == set(js.params) and ts.params["i_embed"].device.type == "cpu"
    rng = np.random.default_rng(3)
    for u in list(rng.choice(np.arange(1, N_USERS + 1), 10, replace=False)) + [UNKNOWN_USER]:
        cands = np.append(rng.choice(np.arange(1, N_ITEMS + 1), 50, replace=False), UNKNOWN_ITEM)
        got = ts(u, ItemList(item_ids=cands)).scores()
        want = js(u, JaxItemList(item_ids=cands)).scores()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert np.isnan(got[-1])
        assert np.isnan(got).all() == (u == UNKNOWN_USER)
    assert supports_device_batch(ts) and not supports_device_batch(cls())
    # the batch route adds both biases and the explicit scorer's global mean
    users = np.append(np.arange(1, 41), UNKNOWN_USER)
    _same_lists(
        device_recommend(ts, users, 10, tds.interaction_matrix(), device="cpu"),
        jax_device_recommend(js, users, 10, jds.interaction_matrix()),
        users,
        10,
    )
    back = pickle.loads(pickle.dumps(ts))
    assert back.dump_config() == ts.dump_config() and back.score_offset() == ts.score_offset()
    for name, t in ts.params.items():
        assert torch.equal(back.params[name], t)
    np.testing.assert_array_equal(back(5, ItemList(item_ids=[1, 2, 3])).scores(), ts(5, ItemList(item_ids=[1, 2, 3])).scores())


def _deterministic_tables(n_users, n_items, k, user_bias, item_bias):
    rng = np.random.default_rng(n_users + 1000 * k)
    out = {"u_embed": rng.standard_normal((n_users, k)), "i_embed": rng.standard_normal((n_items, k))}
    if user_bias:
        out["u_bias"] = rng.standard_normal(n_users)
    if item_bias:
        out["i_bias"] = rng.standard_normal(n_items)
    return {name: (v * 0.1).astype(np.float32) for name, v in out.items()}


def _same_lists(got, want, users, n):
    for u in users:
        g, w = got.lookup(u), want.lookup(u)
        assert len(g) == len(w) == (0 if u == UNKNOWN_USER else n)
        if not len(g):
            continue
        s = w.scores()
        np.testing.assert_allclose(g.scores(), s, rtol=1e-4, atol=1e-4)
        clear = np.ones(n, bool)
        gap = np.abs(np.diff(s)) > 1e-4
        clear[:-1] &= gap
        clear[1:] &= gap
        clear[-1] = False
        np.testing.assert_array_equal(np.asarray(g.ids())[clear], np.asarray(w.ids())[clear])


@pytest.mark.parametrize("preset", ["bpr", "warp", "lightgcn"])
def test_topn_pipeline_recommend_matches_jax(data, preset, deterministic_negatives, monkeypatch):
    """``topn_pipeline`` → ``Pipeline.train`` → ``batch.recommend`` on both
    routes, from the same initial tables in both packages."""
    jds, tds, df = data
    monkeypatch.setattr(jax_flexmf, "init_params", lambda key, *a, scale=0.1: {k: jnp.asarray(v) for k, v in _deterministic_tables(*a).items()})
    monkeypatch.setattr(flexmf, "init_params", lambda gen, *a, scale=0.1: {k: torch.from_numpy(v) for k, v in _deterministic_tables(*a).items()})
    cfg = COMMON | {"preset": preset} | ({"warp_candidates": 8} if preset == "warp" else {})
    jp = lkpy_tpu.topn_pipeline(jax_flexmf.FlexMFImplicitScorer(**cfg), n=10)
    jp.train(jds, JaxTrainingOptions(rng=42))
    tp = topn_pipeline(FlexMFImplicitScorer(**cfg), n=10)
    tp.train(tds, CPU)
    users = np.append(df["user_id"].unique()[:30], UNKNOWN_USER)
    want = jax_batch_recommend(jp, users, n=10)
    batch = recommend(tp, users, n=10)
    assert isinstance(batch, ArrayTopNILC)
    _same_lists(batch, want, users, 10)
    _same_lists(recommend(tp, users, n=10, device=False), want, users, 10)
    assert len(lkpy_tpu_torch.recommend(tp, users[0], n=10)) == 10


def test_predict_pipeline_and_config_round_trip(data):
    _, tds, df = data
    pipe = predict_pipeline(FlexMFExplicitScorer(**COMMON))
    pipe.train(tds, CPU)
    pred = lkpy_tpu_torch.predict(pipe, 3, ItemList(item_ids=[1, 2, UNKNOWN_ITEM]))
    assert len(pred) == 3 and np.isfinite(pred.scores()).all()  # the bias model scores the unknown item
    tp = topn_pipeline(FlexMFImplicitScorer(preset="warp", embedding_size=16), n=5)
    again = Pipeline.from_config(tp.get_config())
    assert again.config_hash() == tp.config_hash()
    assert again.node("scorer").component.config.loss == "warp"


def test_runs_on_the_card_unless_told_cpu(data, monkeypatch):
    _, tds, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlexMFImplicitScorer(**COMMON).train(tds, TrainingOptions())
    with pytest.raises(RuntimeError, match="CUDA"):
        FlexMFImplicitScorer.from_numpy({"u_embed": np.zeros((2, 2)), "i_embed": np.zeros((2, 2))}, Vocabulary([1, 2]), Vocabulary([1, 2]))
