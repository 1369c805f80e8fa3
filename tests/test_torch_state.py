"""Checkpoint and resume (``lkpy_tpu_torch.state``) against the JAX
package's on the CPU: a checkpoint the JAX package writes resumes in the
port's ALS trainer and scorer, and the reverse; a trainer resumed from its
own checkpoint equals one trained straight through; ``epochs_trained`` and
``last_delta`` on the ALS trainers; the FlexMF trainer's tables through a
checkpoint; and the fold-in route named by ``ALSBase.__call__``."""

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models.als import BiasedMFScorer as JaxBiasedMF
from lkpy_tpu.models.als import ImplicitMFScorer as JaxImplicitMF
from lkpy_tpu.state import load_parameters as jax_load_parameters
from lkpy_tpu.state import save_parameters as jax_save_parameters
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.models import FlexMFImplicitScorer
from lkpy_tpu_torch.models.als import ALSBase, BiasedMFScorer, ImplicitMFScorer
from lkpy_tpu_torch.state import ParameterContainer, load_parameters, save_parameters
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

K = 12


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _frame(seed=5, n_users=200, n_items=90):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.5, size=n_users) + 2, n_items // 2)
    users = np.repeat(np.arange(n_users), lens)
    items = np.concatenate([rng.choice(n_items, size=n, replace=False) for n in lens])
    return pd.DataFrame({"user_id": users + 1, "item_id": items + 1000, "rating": rng.integers(1, 11, len(users)) / 2.0})


@pytest.fixture(scope="module")
def datasets():
    df = _frame()
    return jax_from_df(df.copy()), from_interactions_df(df.copy())


@pytest.mark.parametrize("family", ["implicit", "explicit"])
def test_jax_checkpoint_resumes_in_port(datasets, tmp_path, family):
    jds, ds = datasets
    jcls, cls = (JaxImplicitMF, ImplicitMFScorer) if family == "implicit" else (JaxBiasedMF, BiasedMFScorer)
    jt = jcls(features=K, epochs=3).create_trainer(jds, JaxTrainingOptions(rng=42))
    jt.train_epoch()
    jax_save_parameters(jt, tmp_path / "jax.npz")
    tt = cls(features=K, epochs=3).create_trainer(ds, TrainingOptions(rng=7, device="cpu"))
    load_parameters(tt, tmp_path / "jax.npz")
    np.testing.assert_array_equal(tt.u_factors.numpy(), np.asarray(jt.u_factors))
    jt.train_epoch()
    tt.train_epoch()
    got, want = tt.get_parameters(), jt.get_parameters()
    for side in ("user_factors", "item_factors"):
        assert _rel(got[side].numpy(), want[side]) <= 1e-4


def test_port_checkpoint_resumes_in_jax(datasets, tmp_path):
    jds, ds = datasets
    tt = ImplicitMFScorer(features=K, epochs=3).create_trainer(ds, TrainingOptions(rng=42, device="cpu"))
    tt.train_epoch()
    save_parameters(tt, tmp_path / "port.npz")
    jt = JaxImplicitMF(features=K, epochs=3).create_trainer(jds, JaxTrainingOptions(rng=7))
    jax_load_parameters(jt, tmp_path / "port.npz")
    np.testing.assert_array_equal(np.asarray(jt.i_factors), tt.i_factors.numpy())
    tt.train_epoch()
    jt.train_epoch()
    assert _rel(tt.i_factors.numpy(), jt.get_parameters()["item_factors"]) <= 1e-4


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_scorer_checkpoint_across_packages(datasets, tmp_path, direction):
    jds, ds = datasets
    if direction == "jax_to_port":
        src = JaxImplicitMF(features=K, epochs=2)
        src.train(jds, JaxTrainingOptions(rng=42))
        jax_save_parameters(src, tmp_path / "s.npz")
        dst = ImplicitMFScorer(features=K, epochs=2)
        load_parameters(dst, tmp_path / "s.npz", device="cpu")
        assert dst.item_embeddings.device.type == "cpu"
        got, want = dst.item_embeddings.numpy(), src.item_embeddings
    else:
        src = ImplicitMFScorer(features=K, epochs=2)
        src.train(ds, TrainingOptions(rng=42, device="cpu"))
        save_parameters(src, tmp_path / "s.npz")
        dst = JaxImplicitMF(features=K, epochs=2)
        jax_load_parameters(dst, tmp_path / "s.npz")
        got, want = np.asarray(dst.item_embeddings), src.item_embeddings.numpy()
    np.testing.assert_array_equal(got, want)


def test_save_parameters_leaves_out_none(tmp_path):
    class Holder:
        def get_parameters(self):
            return {"a": torch.arange(3.0), "b": None, "c": np.ones(2)}

        def load_parameters(self, state):
            self.state = state

    h = Holder()
    assert isinstance(h, ParameterContainer)
    save_parameters(h, tmp_path / "h.npz")
    load_parameters(h, tmp_path / "h.npz")
    assert sorted(h.state) == ["a", "c"] and h.state["a"].tolist() == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("family", ["implicit", "explicit"])
def test_resume_equals_straight_training(datasets, tmp_path, family):
    _, ds = datasets
    cls = ImplicitMFScorer if family == "implicit" else BiasedMFScorer
    scorer = cls(features=K, epochs=4)
    first = scorer.create_trainer(ds, TrainingOptions(rng=42, device="cpu"))
    assert first.epochs_trained == 0 and first.last_delta is None
    for _ in range(2):
        first.train_epoch()
    save_parameters(first, tmp_path / "c.npz")
    resumed = scorer.create_trainer(ds, TrainingOptions(rng=9, device="cpu"))
    load_parameters(resumed, tmp_path / "c.npz")
    for _ in range(2):
        delta = resumed.train_epoch()
    straight = scorer.create_trainer(ds, TrainingOptions(rng=42, device="cpu"))
    for _ in range(4):
        straight.train_epoch()
    torch.testing.assert_close(resumed.u_factors, straight.u_factors, rtol=0, atol=0)
    torch.testing.assert_close(resumed.i_factors, straight.i_factors, rtol=0, atol=0)
    assert (first.epochs_trained, resumed.epochs_trained, straight.epochs_trained) == (2, 2, 4)
    assert isinstance(resumed.last_delta, torch.Tensor) and resumed.last_delta.dim() == 0
    assert delta is resumed.last_delta and float(resumed.last_delta) == float(straight.last_delta)


def test_epochs_trained_and_last_delta_match_jax(datasets):
    jds, ds = datasets
    jt = JaxImplicitMF(features=K, epochs=3).create_trainer(jds, JaxTrainingOptions(rng=42))
    tt = ImplicitMFScorer(features=K, epochs=3).create_trainer(ds, TrainingOptions(rng=42, device="cpu"))
    for _ in range(3):
        jt.train_epoch()
        tt.train_epoch()
    assert tt.epochs_trained == jt.epochs_trained == 3
    assert abs(float(tt.last_delta) - float(jt.last_delta)) <= 1e-3 * abs(float(jt.last_delta))


def test_flexmf_trainer_through_checkpoint(datasets, tmp_path):
    _, ds = datasets
    scorer = FlexMFImplicitScorer(embedding_size=8, epochs=1, batch_size=256)
    tt = scorer.create_trainer(ds, TrainingOptions(rng=3, device="cpu"))
    tt.train_epoch()
    save_parameters(tt, tmp_path / "f.npz")
    other = scorer.create_trainer(ds, TrainingOptions(rng=4, device="cpu"))
    load_parameters(other, tmp_path / "f.npz")
    for name, v in tt.get_parameters().items():
        np.testing.assert_array_equal(other.get_parameters()[name], v)


def test_fold_in_docstring_names_its_route():
    doc = ALSBase.__call__.__doc__
    assert "gather_gram" in doc and "B2" in doc and "candidates' rows" in doc
