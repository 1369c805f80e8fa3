"""The port's settings (``lkpy_tpu_torch.config``) and schema files
(``lkpy_tpu_torch.schemas``) against the JAX package's on the CPU: the same
configuration files and ``LKT_*`` variables give both packages the same
settings; the root walk and its stops; ``configure`` nesting; the ALS ladder
from ``training_perf.ladder_ratio`` (the chunk plan equal to the JAX
package's, one epoch within 1e-4); ``serving.readback_precision``; and
``TrainingOptions.configured_device(use_default_rng=)``.

The settings are cached process-wide, so every test reads files through
``load_config`` or sets values with ``configure`` (context-local), and the
fixture below drops both packages' caches around each test."""

import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu.config as jax_config
import lkpy_tpu_torch.config as config
from lkpy_tpu.batch.device import device_recommend as jax_device_recommend
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models.als import ImplicitMFScorer as JaxImplicitMF
from lkpy_tpu.schemas import dump_model_data as jax_dump
from lkpy_tpu.schemas import load_model_data as jax_load
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch.device import device_recommend
from lkpy_tpu_torch.config import Settings, configure, load_config, lkpy_tpu_config, locate_configuration_root
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.models.als import ImplicitMFScorer
from lkpy_tpu_torch.schemas import dump_model_data, load_model_data
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_settings(monkeypatch):
    """No cached settings and no LKT_ variables leak in or out."""
    for name in [k for k in __import__("os").environ if k.startswith("LKT_")]:
        monkeypatch.delenv(name)
    monkeypatch.setattr(config, "_loaded", None)
    monkeypatch.setattr(jax_config, "_loaded", None)


def _write(root, main=None, local=None):
    root.mkdir(parents=True, exist_ok=True)
    if main is not None:
        (root / "lkpy-tpu.toml").write_text(main)
    if local is not None:
        (root / "lkpy-tpu.local.toml").write_text(local)
    return root


MAIN = 'random_seed = 7\n[parallel]\nmodel_axis = 2\nthreads = 4\n[training_perf]\nladder_ratio = 1.8\n[serving]\nreadback_precision = "f32"\n'
LOCAL = "random_seed = 8\n[parallel]\nthreads = 6\n"


@pytest.mark.parametrize("env", [{}, {"LKT_RANDOM_SEED": "55", "LKT_SERVING_READBACK_PRECISION": "f16", "LKT_PARALLEL_THREADS": "3"}])
def test_layered_load_equals_jax(tmp_path, monkeypatch, env):
    root = _write(tmp_path / "proj", MAIN, LOCAL)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = load_config(root), jax_config.load_config(root)
    assert got.model_dump() == want.model_dump()
    assert got.parallel.model_axis == 2 and got.training_perf.ladder_ratio == 1.8
    if env:
        assert (got.random_seed, got.serving.readback_precision, got.parallel.threads) == (55, "f16", 3)
    else:
        # the local file wins over the main one, key by key
        assert (got.random_seed, got.parallel.threads, got.serving.readback_precision) == (8, 6, "f32")


def test_defaults_equal_jax():
    assert Settings().model_dump() == jax_config.Settings().model_dump()
    assert lkpy_tpu_config().training_perf.ladder_ratio == 1.35


@pytest.mark.parametrize(
    "layout,expect",
    [
        ("config_here", "proj"),
        ("config_above", "top"),
        ("local_only", "proj"),
        ("stop_at_git", None),
        ("stop_at_pyproject", None),
        ("config_beside_git", "proj"),
    ],
)
def test_root_walk(tmp_path, layout, expect):
    top, proj = tmp_path / "top", tmp_path / "top" / "proj"
    sub = proj / "src" / "deep"
    sub.mkdir(parents=True)
    if layout == "config_here":
        _write(proj, "")
    elif layout == "config_above":
        _write(top, "")
    elif layout == "local_only":
        _write(proj, local="")
    elif layout == "stop_at_git":
        _write(top, "")
        (proj / ".git").mkdir()
    elif layout == "stop_at_pyproject":
        _write(top, "")
        (proj / "pyproject.toml").write_text("")
    else:
        (proj / ".git").mkdir()
        _write(proj, "")
    got = locate_configuration_root(cwd=sub)
    assert got == jax_config.locate_configuration_root(cwd=sub)
    assert got == (None if expect is None else {"proj": proj, "top": top}[expect].resolve())
    if expect is None:
        assert locate_configuration_root(cwd=sub, abort_at_gitroot=False, abort_at_pyproject=False) == top.resolve()


def test_load_config_walks_from_cwd(tmp_path, monkeypatch):
    root = _write(tmp_path / "proj", "random_seed = 11\n")
    (root / "a").mkdir()
    monkeypatch.chdir(root / "a")
    assert load_config().random_seed == 11
    assert lkpy_tpu_config().random_seed == 11


def test_configure_nesting():
    base = lkpy_tpu_config()
    with configure(random_seed=1, training_perf={"ladder_ratio": 2.0}) as outer:
        assert outer is lkpy_tpu_config() and lkpy_tpu_config().random_seed == 1
        with configure(serving={"readback_precision": "f16"}):
            inner = lkpy_tpu_config()
            assert (inner.random_seed, inner.training_perf.ladder_ratio, inner.serving.readback_precision) == (1, 2.0, "f16")
        assert lkpy_tpu_config().serving.readback_precision == "auto"
        assert lkpy_tpu_config().training_perf.ladder_ratio == 2.0
    assert lkpy_tpu_config() is base


@pytest.mark.parametrize("suffix", [".toml", ".json", ".yaml"])
def test_schema_files_across_packages(tmp_path, suffix):
    s = Settings.model_validate({"random_seed": 3, "parallel": {"threads": 2}, "prometheus": {"power_queries": {"gpu": "q"}}})
    dump_model_data(s, tmp_path / f"port{suffix}")
    jax_dump(jax_config.Settings.model_validate(s.model_dump()), tmp_path / f"jax{suffix}")
    assert (tmp_path / f"port{suffix}").read_text() == (tmp_path / f"jax{suffix}").read_text()
    assert load_model_data(tmp_path / f"jax{suffix}", Settings) == s
    assert jax_load(tmp_path / f"port{suffix}") == load_model_data(tmp_path / f"port{suffix}")
    (tmp_path / "x.ini").write_text("")
    with pytest.raises(ValueError):
        load_model_data(tmp_path / "x.ini")


N_USERS, N_ITEMS, K = 300, 120, 16


def _frame(seed=3):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.4, size=N_USERS) + 2, N_ITEMS // 2)
    users = np.repeat(np.arange(N_USERS), lens)
    items = np.concatenate([rng.choice(N_ITEMS, size=n, replace=False) for n in lens])
    return pd.DataFrame({"user_id": users + 10, "item_id": items * 2 + 1})


def _plan(trainer):
    return [(tuple(c.cols.shape), np.asarray(c.rows).reshape(-1)[: c.n_real].tolist()) for c in trainer.u_buckets + trainer.i_buckets]


def _jax_plan(trainer):
    out = []
    for c in trainer.u_buckets + trainer.i_buckets:
        rows = np.asarray(c.rows).reshape(-1)
        out.append((tuple(c.cols.shape), rows[rows < np.iinfo(np.int32).max].tolist()))
    return out


@pytest.fixture(scope="module")
def datasets():
    df = _frame()
    return jax_from_df(df.copy()), from_interactions_df(df.copy())


def test_ladder_plan_and_epoch_equal_jax(datasets):
    jds, ds = datasets
    with configure(training_perf={"ladder_ratio": 2.0}), jax_config.configure(training_perf={"ladder_ratio": 2.0}):
        jt = JaxImplicitMF(features=K, epochs=1).create_trainer(jds, JaxTrainingOptions(rng=42))
        tt = ImplicitMFScorer(features=K, epochs=1).create_trainer(ds, TrainingOptions(rng=42, device="cpu"))
    default = ImplicitMFScorer(features=K, epochs=1).create_trainer(ds, TrainingOptions(rng=42, device="cpu"))
    assert _plan(tt) == _jax_plan(jt)
    assert len(_plan(tt)) < len(_plan(default))
    np.testing.assert_array_equal(tt.u_factors.numpy(), np.asarray(jt.u_factors))
    jt.train_epoch()
    tt.train_epoch()
    for side in ("user_factors", "item_factors"):
        got, want = tt.get_parameters()[side].numpy().astype(np.float64), np.asarray(jt.get_parameters()[side], np.float64)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4
    # the same epoch on the default ladder: padding changes the shapes, not the sums
    default.train_epoch()
    got, want = tt.i_factors.double(), default.i_factors.double()
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-4


@pytest.mark.parametrize("precision", ["f16", "f32", "auto"])
def test_readback_precision_equals_jax(datasets, precision):
    jds, ds = datasets
    js = JaxImplicitMF(features=K, epochs=2)
    js.train(jds, JaxTrainingOptions(rng=42))
    ts = ImplicitMFScorer.from_numpy(
        {"user_embeddings": js.user_embeddings, "item_embeddings": js.item_embeddings, "_OtOr": js._OtOr},
        {"features": K}, ds.users, ds.items, device="cpu",
    )  # fmt: skip
    users = ds.users.ids[::7]
    plain = device_recommend(ts, users, 8, ds.interaction_matrix(), device="cpu")
    with configure(serving={"readback_precision": precision}), jax_config.configure(serving={"readback_precision": precision}):
        got = device_recommend(ts, users, 8, ds.interaction_matrix(), device="cpu")
        want = jax_device_recommend(js, users, 8, jds.interaction_matrix())
    for u in users:
        g, w, p = got.lookup(u), want.lookup(u), plain.lookup(u)
        np.testing.assert_array_equal(g.ids(), p.ids())
        s = p.scores()
        if precision == "f16":
            np.testing.assert_array_equal(g.scores(), s.astype(np.float16).astype(np.float32))
        else:
            np.testing.assert_array_equal(g.scores(), s)
        # the JAX package's scores: the same rounding of float32 sums that agree to ~1e-6
        gap = np.abs(w.scores() - g.scores())
        spacing = np.spacing(np.abs(w.scores()).astype(np.float16)).astype(np.float32) if precision == "f16" else 1e-5 * np.abs(w.scores())
        assert (gap <= spacing + 1e-6).all()


def test_configured_device_takes_use_default_rng():
    opts = TrainingOptions(device="cpu")
    assert opts.configured_device(use_default_rng=True) == opts.configured_device() == torch.device("cpu")
