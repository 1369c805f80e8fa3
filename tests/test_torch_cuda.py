"""On-card tests of the port's kernels and of its serving slice.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor ``lkpy_tpu``, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu_torch.batch.device import device_recommend
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.models.als import ImplicitMFScorer
from lkpy_tpu_torch.ops.als import implicit_otor
from lkpy_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd_batch(rng, B, k, reg=2.0):
    X = rng.standard_normal((B, k, k)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1) + reg * np.eye(k, dtype=np.float32)
    y = rng.standard_normal((B, k)).astype(np.float32)
    return A, y


@pytest.mark.parametrize("B,k", [(1024, 64), (1000, 50), (7, 8), (333, 128), (64, 256), (3, 1)])
def test_kernel_matches_plain(cuda, B, k):
    rng = np.random.default_rng(B + k)
    A, y = (torch.from_numpy(a).to(cuda) for a in _spd_batch(rng, B, k))
    before = spd_solve.launches
    x = spd_solve(A, y)
    torch.cuda.synchronize()
    assert spd_solve.launches == before + 1
    # the same f32 operations in the same order on both sides
    torch.testing.assert_close(x, spd_solve_plain(A, y), rtol=1e-4, atol=1e-6)


def test_kernel_zero_diagonal_is_nonfinite(cuda):
    rng = np.random.default_rng(6)
    A, y = _spd_batch(rng, 3, 64)
    A[1] = 0.0
    x = spd_solve(torch.from_numpy(A).to(cuda), torch.from_numpy(y).to(cuda)).cpu().numpy()
    assert not np.isfinite(x[1]).any()
    assert np.isfinite(x[[0, 2]]).all()


def test_serving_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(11)
    n_users, n_items, k = 300, 500, 32
    u = np.repeat(np.arange(n_users), rng.integers(1, 150, size=n_users))
    i = rng.integers(0, n_items, size=len(u))
    ds = from_interactions_df(pd.DataFrame({"user_id": u, "item_id": i}))
    items = rng.standard_normal((ds.item_count, k)).astype(np.float32) * 0.3
    params = {
        "user_embeddings": rng.standard_normal((ds.user_count, k)).astype(np.float32) * 0.3,
        "item_embeddings": items,
        "_OtOr": implicit_otor(torch.from_numpy(items), 0.1).numpy(),
    }
    users = np.concatenate([ds.users.ids[::2], [-5]])
    out = {}
    for dev in ("cpu", cuda):
        scorer = ImplicitMFScorer.from_numpy(params, {"features": k}, ds.users, ds.items, device=dev)
        before = spd_solve.launches
        out[str(dev)] = device_recommend(scorer, users, 20, ds.interaction_matrix(), chunk=64, device=dev)
        if dev == cuda:
            assert spd_solve.launches > before
    for (key, il_cpu), (key2, il_gpu) in zip(out["cpu"].items(), out["cuda"].items()):
        assert key == key2
        assert len(il_cpu) == len(il_gpu)
        np.testing.assert_allclose(il_gpu.scores(), il_cpu.scores(), rtol=1e-4, atol=1e-4)
    assert len(out["cuda"].lookup(-5)) == 0
