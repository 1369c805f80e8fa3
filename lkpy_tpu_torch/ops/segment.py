"""
Segment reductions: sums, counts and damped means by segment number (port of
``lkpy_tpu/ops/segment.py``; reference: src/lenskit/basic/bias.py:84
``np.add.at`` loops).  Each is one ``index_add_`` on the values' device.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum", "segment_count", "segment_mean"]


def segment_sum(values: torch.Tensor, segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum ``values`` by segment number."""
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, segments.long(), values)


def segment_count(segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Count entries per segment (float32)."""
    return segment_sum(torch.ones(segments.shape, dtype=torch.float32, device=segments.device), segments, num_segments)


def segment_mean(
    values: torch.Tensor, segments: torch.Tensor, num_segments: int, *, damping: float = 0.0
) -> torch.Tensor:
    """
    (Damped) per-segment mean: sum / (count + damping); 0 for empty segments.
    Matches the reference bias damping semantics (reference: basic/bias.py:84).
    """
    sums = segment_sum(values, segments, num_segments)
    denom = segment_count(segments, num_segments) + damping
    return torch.where(denom > 0, sums / denom.clamp_min(1e-12), 0.0)
