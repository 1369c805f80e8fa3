"""The port's serving slice as a whole against the JAX package on the CPU.

A JAX ``ImplicitMFScorer`` is trained on a small synthetic set (a reduced
``bench.py::synth_interactions``, with users past 64 history items so two
history-width rungs are served), carried across with
``ImplicitMFScorer.from_numpy``, and both packages' ``device_recommend``
results are compared.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.batch.device import device_recommend as jax_device_recommend
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models.als import ImplicitMFScorer as JaxImplicitMF
from lkpy_tpu.training import TrainingOptions
from lkpy_tpu_torch.batch.device import device_recommend
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.models.als import ImplicitMFScorer
from lkpy_tpu_torch.ops.spd_solve import spd_solve

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
#: score tolerance: the two packages solve the fold-in systems with
#: differently ordered f32 arithmetic (LAPACK Cholesky vs the port's)
TOL = 1e-4


def synth_interactions(rng, n_users=300, n_items=400, nnz=30_000, n_groups=4):
    """``bench.py::synth_interactions`` at a reduced size."""
    item_w = 1.0 / np.arange(1, n_items + 1) ** 0.8
    cdf = np.cumsum(item_w / item_w.sum())
    users = rng.integers(0, n_users, size=nnz)
    user_group = rng.integers(0, n_groups, size=n_users)
    in_group = rng.random(nnz) < 0.75
    raw = np.searchsorted(cdf, rng.random(nnz))
    snapped = np.minimum((raw // n_groups) * n_groups + user_group[users], n_items - 1)
    items = np.where(in_group, snapped, raw)
    key = np.unique(users * n_items + items)
    return key // n_items, key % n_items


@pytest.fixture(scope="module")
def trained():
    u, i = synth_interactions(np.random.default_rng(42))
    df = pd.DataFrame({"user_id": u, "item_id": i})
    jds = jax_from_df(df)
    jax_scorer = JaxImplicitMF(features=16, epochs=3)
    jax_scorer.train(jds, TrainingOptions(rng=42))
    lens = np.bincount(u)
    assert (lens <= 64).any() and (lens > 64).any()  # two history-width rungs
    return jds, from_interactions_df(df), jax_scorer


def _scorers(trained, user_embeddings):
    jds, tds, fitted = trained
    cfg = {"features": 16, "epochs": 3, "user_embeddings": user_embeddings}
    js = JaxImplicitMF(JaxImplicitMF.validate_config(cfg))
    js.users, js.items = fitted.users, fitted.items
    js.user_embeddings, js.item_embeddings, js._OtOr = fitted.user_embeddings, fitted.item_embeddings, fitted._OtOr
    params = {"user_embeddings": js.user_embeddings, "item_embeddings": js.item_embeddings, "_OtOr": js._OtOr}
    ts = ImplicitMFScorer.from_numpy(params, cfg, tds.users, tds.items, device="cpu")
    return js, ts


@pytest.mark.parametrize("user_embeddings", [True, "prefer"])
@pytest.mark.parametrize("n", [10, 500])
def test_device_recommend_matches_jax(trained, user_embeddings, n):
    jds, tds, _ = trained
    js, ts = _scorers(trained, user_embeddings)
    users = np.concatenate([jds.users.ids[::3], [-7, 10**6]])
    ref = jax_device_recommend(js, users, n, jds.interaction_matrix(), chunk=32)
    before = spd_solve.launches
    got = device_recommend(ts, users, n, tds.interaction_matrix(), chunk=32, device="cpu")
    assert spd_solve.launches == before  # CPU tensors take the plain version
    assert len(got) == len(ref) == len(users)
    matrix = tds.interaction_matrix()
    for (gk, gl), (rk, rl) in zip(got.items(), ref.items()):
        assert gk.user_id == rk.user_id
        assert len(gl) == len(rl)
        gs, rs = gl.scores(), rl.scores()
        np.testing.assert_allclose(gs, rs, rtol=TOL, atol=TOL)
        if len(rs) > 1:
            gaps = np.abs(np.diff(rs))
            clear = np.ones(len(rs), bool)
            clear[:-1] &= gaps > TOL
            clear[1:] &= gaps > TOL
            if len(rs) == min(n, tds.item_count):
                clear[-1] = False  # the cut-off may fall inside a tie
            np.testing.assert_array_equal(gl.ids()[clear], rl.ids()[clear])
        hist = matrix.row_items(gk.user_id)
        if hist is None:
            assert len(gl) == 0
        else:
            assert not np.isin(gl.ids(), hist.ids()).any()


def test_use_ratings_fold_in_matches_jax():
    # rating-weighted confidences: the serving engine gathers the CSR's
    # rating values on the device as well as its columns
    rng = np.random.default_rng(3)
    u, i = synth_interactions(rng, n_users=120, n_items=200, nnz=8_000)
    df = pd.DataFrame({"user_id": u, "item_id": i, "rating": rng.integers(1, 11, size=len(u)) / 2.0})
    jds, tds = jax_from_df(df), from_interactions_df(df)
    k = 8
    items = (rng.standard_normal((jds.item_count, k)) * 0.3).astype(np.float32)
    otor = (items.astype(np.float64).T @ items + 0.1 * np.eye(k)).astype(np.float32)
    cfg = {"features": k, "use_ratings": True, "weight": 10.0}
    params = {
        "user_embeddings": (rng.standard_normal((jds.user_count, k)) * 0.3).astype(np.float32),
        "item_embeddings": items,
        "_OtOr": otor,
    }
    js = JaxImplicitMF(JaxImplicitMF.validate_config(cfg))
    js.users, js.items = jds.users, jds.items
    js.user_embeddings, js.item_embeddings, js._OtOr = params["user_embeddings"], items, otor
    ts = ImplicitMFScorer.from_numpy(params, cfg, tds.users, tds.items, device="cpu")
    users = jds.users.ids[::2]
    ref = jax_device_recommend(js, users, 15, jds.interaction_matrix(), chunk=16)
    got = device_recommend(ts, users, 15, tds.interaction_matrix(), chunk=16, device="cpu")
    for (gk, gl), (rk, rl) in zip(got.items(), ref.items()):
        assert gk.user_id == rk.user_id and len(gl) == len(rl)
        np.testing.assert_allclose(gl.scores(), rl.scores(), rtol=TOL, atol=TOL)

    # without its user table (trained with user_embeddings=False) neither
    # package serves the scorer in batch
    js.user_embeddings = None
    ts.user_embeddings = None
    with pytest.raises(TypeError):
        jax_device_recommend(js, users, 15, jds.interaction_matrix())
    with pytest.raises(TypeError):
        device_recommend(ts, users, 15, tds.interaction_matrix(), device="cpu")


def test_port_loads_no_jax():
    code = """
import sys


class Blocked:
    # jax, jaxlib and lkpy_tpu cannot be imported at all in this process
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "lkpy_tpu"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np, pandas as pd
from lkpy_tpu_torch.batch.device import device_recommend
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.models.als import ImplicitMFScorer
from lkpy_tpu_torch.ops.als import implicit_otor
import torch
rng = np.random.default_rng(0)
ds = from_interactions_df(pd.DataFrame({"user_id": rng.integers(0, 40, 600), "item_id": rng.integers(0, 90, 600)}))
items = rng.standard_normal((ds.item_count, 8)).astype(np.float32)
params = {
    "user_embeddings": rng.standard_normal((ds.user_count, 8)).astype(np.float32),
    "item_embeddings": items,
    "_OtOr": implicit_otor(torch.from_numpy(items), 0.1).numpy(),
}
scorer = ImplicitMFScorer.from_numpy(params, {"features": 8}, ds.users, ds.items, device="cpu")
recs = device_recommend(scorer, ds.users.ids, 5, ds.interaction_matrix(), device="cpu")
assert recs.total_items() > 0
# the training slice: trainer, epochs, bucketing, the training solve
import lkpy_tpu_torch.random, lkpy_tpu_torch.ops.sparse, lkpy_tpu_torch.ops.spd_solve_chunked
from lkpy_tpu_torch.training import TrainingOptions
trained = ImplicitMFScorer(features=8, epochs=2)
trained.train(ds, TrainingOptions(rng=1, device="cpu"))
assert device_recommend(trained, ds.users.ids, 5, ds.interaction_matrix(), device="cpu").total_items() > 0
# the retrieval slice and the explicit family
import lkpy_tpu_torch.ops as ops, lkpy_tpu_torch.ops.mips_topk, lkpy_tpu_torch.ops.segment, lkpy_tpu_torch.data.query
from lkpy_tpu_torch.ops.topk import retrieval_topk
from lkpy_tpu_torch.models.als import BiasedMFScorer
from lkpy_tpu_torch.models.bias import BiasScorer
v, i = retrieval_topk(trained.user_embeddings, trained.item_embeddings, 5)
assert v.shape == (ds.user_count, 5) and ops.top_n_indices(v, 2).shape == (ds.user_count, 2)
rated = from_interactions_df(pd.DataFrame({"user_id": rng.integers(0, 40, 600), "item_id": rng.integers(0, 90, 600),
                                           "rating": rng.integers(1, 6, 600).astype(np.float32)}))
mf = BiasedMFScorer(features=6, epochs=2)
mf.train(rated, TrainingOptions(rng=1, device="cpu"))
assert device_recommend(mf, rated.users.ids, 5, rated.interaction_matrix(), device="cpu").total_items() > 0
from lkpy_tpu_torch.data import ItemList
assert np.isfinite(mf(rated.users.ids[0], ItemList(item_ids=rated.items.ids[:4])).scores()).all()
bs = BiasScorer(damping=5.0)
bs.train(rated, TrainingOptions(device="cpu"))
assert np.isfinite(bs(rated.users.ids[0], ItemList(item_ids=rated.items.ids[:4])).scores()).all()
# the user's path: pipeline, batch and per-query recommend
import lkpy_tpu_torch
from lkpy_tpu_torch.batch import recommend
pipe = lkpy_tpu_torch.topn_pipeline(ImplicitMFScorer(features=8, epochs=2), n=5)
pipe.train(ds, TrainingOptions(rng=1, device="cpu"))
assert recommend(pipe, ds.users.ids[:9], n=5).total_items() > 0
assert len(lkpy_tpu_torch.recommend(pipe, ds.users.ids[0], n=5)) == 5
# offline evaluation: splitting, metrics and quick_measure_model
import lkpy_tpu_torch.metrics, lkpy_tpu_torch.splitting
from lkpy_tpu_torch.metrics import quick_measure_model
from lkpy_tpu_torch.splitting import SampleN, sample_users
assert len(sample_users(ds, 5, SampleN(2, rng=1), rng=1).test) == 5
assert np.isfinite(quick_measure_model(ImplicitMFScorer(features=4, epochs=1), ds, n_recs=5, device="cpu").global_metrics()).all()
# the item-item family: kNN builds and scoring, EASE
from lkpy_tpu_torch.models import EASEScorer, ItemKNNScorer, UserKNNScorer
from lkpy_tpu_torch.ops.knn import similarity_topk
import lkpy_tpu_torch.utils.residency
for knn_scorer in (ItemKNNScorer(feedback="implicit"), UserKNNScorer(), EASEScorer()):
    knn_pipe = lkpy_tpu_torch.topn_pipeline(knn_scorer, n=5)
    knn_pipe.train(rated, TrainingOptions(device="cpu"))
    assert recommend(knn_pipe, rated.users.ids[:3], n=5).total_items() > 0
assert rated.interaction_matrix().scipy("rating").nnz > 0
# the gradient family: negative sampling, graph propagation, FlexMF and LightGCN
from lkpy_tpu_torch.models import FlexMFExplicitScorer, FlexMFImplicitScorer, LightGCNScorer
for grad_scorer, data in ((FlexMFImplicitScorer(preset="warp", embedding_size=4, epochs=1, warp_candidates=4), ds),
                          (FlexMFImplicitScorer(preset="lightgcn", embedding_size=4, epochs=1), ds),
                          (FlexMFExplicitScorer(embedding_size=4, epochs=1), rated), (LightGCNScorer(embedding_size=4, epochs=1), ds)):
    grad_pipe = lkpy_tpu_torch.topn_pipeline(grad_scorer, n=5)
    grad_pipe.train(data, TrainingOptions(rng=1, device="cpu"))
    assert recommend(grad_pipe, data.users.ids[:3], n=5).total_items() > 0
# the data layer and runtime core: storage, the lazy dataset, settings, checkpoints, schema files, MTArray,
# stochastic ranking
import tempfile
from lkpy_tpu_torch import schemas, state
from lkpy_tpu_torch.config import configure, lkpy_tpu_config
from lkpy_tpu_torch.data import Dataset
from lkpy_tpu_torch.data.mtarray import MTArray
from lkpy_tpu_torch.models.stochastic import StochasticTopNRanker
with tempfile.TemporaryDirectory() as d:
    rated.save(d)
    with configure(training_perf={"ladder_ratio": 2.0}):
        t = ImplicitMFScorer(features=4, epochs=1).create_trainer(Dataset(lambda: Dataset.load(d)), TrainingOptions(rng=1, device="cpu"))
        t.train_epoch()
    state.save_parameters(t, d + "/p.npz")
    state.load_parameters(t, d + "/p.npz")
    schemas.dump_model_data(lkpy_tpu_config(), d + "/s.toml")
    assert schemas.load_model_data(d + "/s.toml", type(lkpy_tpu_config())).training_perf.ladder_ratio == 1.35
assert int(MTArray(np.arange(3)).torch().sum()) == 3
assert len(StochasticTopNRanker(n=2, rng=1)(ItemList(item_ids=[1, 2, 3], scores=[0.1, 0.2, 0.3]))) == 2
# the rest of the zoo and the batch runner's rest: FunkSVD, SLIM, BiasedSVD, NMF, association, FA*IR, the bridges,
# timings
from lkpy_tpu_torch.models import AssociationScorer, FunkSVDScorer, SLIMScorer
from lkpy_tpu_torch.models.fair import FAIRReranker
from lkpy_tpu_torch.models.hpf import HPFScorer
from lkpy_tpu_torch.models.implicit_bridge import ALS
from lkpy_tpu_torch.models.nmf import NMFScorer
from lkpy_tpu_torch.models.svd import BiasedSVDScorer
for zoo_scorer, data in ((FunkSVDScorer(features=3, epochs=2, batch_size=64), rated), (BiasedSVDScorer(features=3), rated),
                         (NMFScorer(features=3, max_iter=5), rated), (SLIMScorer(max_iters=5), ds), (AssociationScorer(), ds)):
    zoo_pipe = lkpy_tpu_torch.topn_pipeline(zoo_scorer, n=5)
    zoo_pipe.train(data, TrainingOptions(rng=1, device="cpu"))
    assert recommend(zoo_pipe, data.users.ids[:3], n=5).total_items() > 0
timings = {}
device_recommend(trained, ds.users.ids, 5, ds.interaction_matrix(), device="cpu", timings=timings)
assert timings["tunnel_ops"] == len(timings["trace"])
for bridge in (HPFScorer(), ALS()):
    try:
        bridge.train(ds)
    except ImportError:
        pass
assert FAIRReranker(n=3).config.n == 3
# every module of the package, and the chip smoke script
import importlib, pkgutil
for m in pkgutil.walk_packages(lkpy_tpu_torch.__path__, "lkpy_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lkpy_tpu"))
print(",".join(bad))
"""
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the port loaded {out.stdout.strip()}"
