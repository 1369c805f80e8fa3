"""The public names that the port took over last from the JAX package, on
the CPU: ``ops``' re-exports of the sparse layouts, the kernel build
directory behind ``config.ensure_compile_cache``, and the Jupyter progress
backend (ipywidgets is installed here; its absence is simulated)."""

import builtins
import logging
import warnings

import numpy as np
import pytest

import lkpy_tpu.config as jax_config
import lkpy_tpu.ops as jax_ops
import lkpy_tpu_torch.ops as ops
from lkpy_tpu_torch import config
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.logging import logger, notebook_logging, progress
from lkpy_tpu_torch.ops import _build, sparse


def test_ops_names_match_jax():
    assert set(jax_ops.__all__) <= set(ops.__all__)
    assert (ops.DeviceCOO, ops.PaddedRowMatrix, ops.bucket_rows, ops.pad_rows) == (sparse.DeviceCOO, sparse.PaddedRowMatrix, sparse.bucket_rows, sparse.pad_rows)
    csr = CSR.from_coo(np.array([0, 0, 2]), np.array([1, 3, 0]), np.array([1.0, 2.0, 3.0], np.float32), (3, 4))
    coo = ops.DeviceCOO.from_csr(csr, device="cpu")
    assert coo.nnz == 3 and coo.row.tolist() == [0, 0, 2]


def test_kernel_build_dir_follows_the_settings(monkeypatch, tmp_path):
    assert callable(jax_config.ensure_compile_cache) and "ensure_compile_cache" in config.__all__
    monkeypatch.delenv("LKT_CACHE_DIR", raising=False)
    default = config.kernel_build_dir()
    name = _build.library_path("gather_rows").name
    assert default == config.DEFAULT_BUILD_DIR and default.parts[-2:] == ("build", "lkpy_tpu_torch")
    assert _build.library_path("gather_rows").parent == default
    monkeypatch.setenv("LKT_CACHE_DIR", str(tmp_path / "env"))
    assert config.kernel_build_dir() == tmp_path / "env"
    with config.configure(compile_cache={"dir": str(tmp_path / "set")}):
        made = config.ensure_compile_cache()
        assert made == tmp_path / "set" and made.is_dir()
        assert _build.library_path("gather_rows").parent == made
        # the name still hashes the sources and flags only
        assert _build.library_path("gather_rows").name == name
    assert config.ensure_compile_cache() == tmp_path / "env" and (tmp_path / "env").is_dir()


def _without_ipywidgets(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kwargs):
        if name.split(".")[0] == "ipywidgets":
            raise ImportError("no ipywidgets")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", fake)


@pytest.fixture
def restore_impl():
    yield
    progress.set_progress_impl(None)


def test_notebook_progress_bar(restore_impl, monkeypatch):
    shown, applied = [], []
    monkeypatch.setattr("IPython.display.display", shown.append)
    # notebook_logging's console set-up, kept out of the test process's logging
    monkeypatch.setattr(logger.LoggingConfig, "apply", lambda self: applied.append(self.level))
    notebook_logging(logging.DEBUG)
    assert applied == [logging.DEBUG] and progress._impl == "notebook"
    bar = progress.item_progress("epochs", total=4)
    assert type(bar).__name__ == "_JupyterProgress" and shown == [bar._box]
    bar.update()
    bar.update(2)
    assert (bar._bar.value, bar._bar.max, bar._text.value) == (3, 4, "3 / 4")
    bar.finish()
    assert (bar._bar.bar_style, bar._text.value) == ("success", "✓")
    with progress.item_progress_handle("open-ended") as open_ended:
        assert open_ended._bar.bar_style == "info"
        open_ended.update()
    assert open_ended._text.value == "✓" and open_ended.completed == 1


def test_notebook_progress_falls_back_without_ipywidgets(restore_impl, monkeypatch):
    _without_ipywidgets(monkeypatch)
    progress.set_progress_impl("notebook")
    with pytest.warns(UserWarning, match="ipywidgets"):
        bar = progress.item_progress("epochs", total=2)
    assert type(bar) is progress.Progress
    bar.update(2)
    assert bar.completed == 2


def test_auto_progress_outside_a_notebook_is_silent(restore_impl):
    progress.set_progress_impl("auto")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bar = progress.item_progress("x", total=1)
    assert type(bar) in (progress.Progress, progress._RichProgress)
    bar.finish()
    assert not progress._in_notebook()
