"""
Faults planted under the timed path, each of which the check has to catch:
a step that returns its state unchanged, half of the rows left out, a
served item altered or repeated where it is produced.  Each plant takes
``patch(obj, name, value)`` (``pytest``'s ``monkeypatch.setattr``, or
:func:`planted`'s) and replaces one function of the program.

Used by ``portbench/tests/`` at a size the CPU holds and by
``control.py --fault`` on the card at the cell's own size.
"""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "planted"]


def unchanged_epoch(patch):
    """ALS: an epoch that leaves the tables as they were."""
    from lkpy_tpu_torch.models.als import ALSTrainerBase

    patch(ALSTrainerBase, "train_epoch", lambda self: None)


def half_rows(patch):
    """ALS: the second half of every chunk's rows left unsolved (zero)."""
    import lkpy_tpu_torch.ops.als as als

    orig = als._solve_chunk

    def half(*a, **kw):
        x = orig(*a, **kw)
        x[x.shape[0] // 2 :] = 0
        return x

    patch(als, "_solve_chunk", half)


def altered_answer(patch):
    """Serving: every served item moved to the next item number."""
    import lkpy_tpu_torch.batch.serving as sv

    orig = sv._topn_scores

    def shifted(scores, hist_cols, hist_mask, n):
        v, ix = orig(scores, hist_cols, hist_mask, n)
        return v, (ix + 1) % scores.shape[1]

    patch(sv, "_topn_scores", shifted)


def half_block(patch):
    """Serving: the second half of a block's users given the first half's lists."""
    import lkpy_tpu_torch.batch.serving as sv

    orig = sv._topn_scores

    def halved(scores, hist_cols, hist_mask, n):
        v, ix = orig(scores, hist_cols, hist_mask, n)
        h = v.shape[0] // 2
        v, ix = v.clone(), ix.clone()
        v[h : 2 * h], ix[h : 2 * h] = v[:h], ix[:h]
        return v, ix

    patch(sv, "_topn_scores", halved)


def duplicate_items(patch):
    """Serving: every place of a list given its first item."""
    import lkpy_tpu_torch.batch.serving as sv

    orig = sv._topn_scores

    def repeated(scores, hist_cols, hist_mask, n):
        v, ix = orig(scores, hist_cols, hist_mask, n)
        return v[:, :1].expand_as(v).contiguous(), ix[:, :1].expand_as(ix).contiguous()

    patch(sv, "_topn_scores", repeated)


#: the faults each kind of cell can have, by the traffic mix's loop and the family
FAULTS = {
    ("train_epochs", "als_implicit"): [unchanged_epoch, half_rows],
    ("serve_closed", "als_implicit"): [altered_answer, half_block, duplicate_items],
}


@contextlib.contextmanager
def planted(fault):
    """Plant ``fault`` for the duration of the block."""
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    fault(patch)
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
