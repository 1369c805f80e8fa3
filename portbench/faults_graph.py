"""
Faults planted under the gradient family's timed path, each of which the
LightGCN check has to catch: a propagation layer dropped, a backward that
returns zeros through the sparse products, negatives left unverified.  Each
plant takes ``patch(obj, name, value)``, as those of :mod:`portbench.faults`
do, so :func:`portbench.faults.planted` plants them too.

Used by ``portbench/tests/`` at a size the CPU holds and, on the card at
the cell's own size, by a script that calls ``run_cell`` under ``planted``.
"""

from __future__ import annotations

import torch

__all__ = ["FAULTS", "dropped_layer", "unverified_negatives", "zero_backward"]


def dropped_layer(patch):
    """LightGCN: the last propagation layer left out of the blend."""
    import lkpy_tpu_torch.models.lightgcn as lightgcn

    orig = lightgcn.propagate

    def fewer(u, i, conv, blend):
        return orig(u, i, conv, blend[:-1])

    patch(lightgcn, "propagate", fewer)


def zero_backward(patch):
    """The sparse products' backward: zeros in place of ``a_t @ g``."""
    from lkpy_tpu_torch.ops.graph import _CSRMM

    def zeros(ctx, g):
        return torch.zeros((ctx.a_t.shape[0], g.shape[1]), dtype=g.dtype, device=g.device), None, None

    patch(_CSRMM, "backward", staticmethod(zeros))


def unverified_negatives(patch):
    """Negatives: each slot's first candidate, unchecked against the user's items."""
    import lkpy_tpu_torch.ops.sampling as sampling

    patch(sampling, "choose_negatives", lambda index, rows, cands: cands[:, :, 0])


#: the faults of the LightGCN cell, by the traffic mix's loop and the family
FAULTS = {("train_epochs", "lightgcn"): [dropped_layer, zero_backward, unverified_negatives]}
