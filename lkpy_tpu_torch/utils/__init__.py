"""Small utilities (port of ``lkpy_tpu.utils``; reference: src/lenskit/util/,
src/lenskit/stats.py)."""

from lkpy_tpu_torch.utils.stats import gini

__all__ = ["gini"]
