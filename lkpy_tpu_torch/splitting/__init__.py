"""
Train/test splitting for offline evaluation (port of ``lkpy_tpu.splitting``).

Capability parity with reference ``lenskit.splitting``
(reference: src/lenskit/splitting/): ``TTSplit`` (_split.py:23), holdout
methods (_holdout.py:44-131), user-based splits (_users.py:27,85),
record-based splits (_records.py:24,72), temporal splits (_temporal.py:20,124).
Splitting is host NumPy and pandas, as in the JAX package; one seed gives
the same split in both packages.
"""

from lkpy_tpu_torch.splitting.holdout import HoldoutMethod, LastFrac, LastN, SampleFrac, SampleN
from lkpy_tpu_torch.splitting.records import crossfold_records, sample_records
from lkpy_tpu_torch.splitting.split import TTSplit
from lkpy_tpu_torch.splitting.temporal import split_global_time, split_temporal_fraction
from lkpy_tpu_torch.splitting.users import crossfold_users, sample_users

__all__ = [
    "HoldoutMethod",
    "LastFrac",
    "LastN",
    "SampleFrac",
    "SampleN",
    "TTSplit",
    "crossfold_records",
    "crossfold_users",
    "sample_records",
    "sample_users",
    "simple_test_pair",
    "split_global_time",
    "split_temporal_fraction",
]


def simple_test_pair(ratings, n_users=200, n_rates=5, f_rates=None, rng=None):
    """One basic train-test pair — convenience for tests and demos only
    (reference: splitting/__init__.py:38)."""
    method = SampleFrac(f_rates, rng=rng) if f_rates else SampleN(n_rates, rng=rng)
    return sample_users(ratings, n_users, method, rng=rng)
