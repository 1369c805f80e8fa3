"""
Batch (offline) inference (port of ``lkpy_tpu.batch``; reference:
src/lenskit/batch/__init__.py, _runner.py:60): the ``BatchPipelineRunner``
with recommend/predict/score invocations, and the module-level
``recommend``/``predict``/``score`` helpers.

Generic pipelines run per query on the host.  A standard top-N pipeline
over an embedding-family scorer takes the device route
(:func:`lkpy_tpu_torch.batch.device.try_device_recommend`): the whole batch
of users is served at once, with fold-in, on the device where the scorer's
tables lie, or with ``mesh=`` over the ``data`` slots of a
:class:`~lkpy_tpu_torch.parallel.mesh.Mesh`; ``distributed=True`` also
splits the users over the processes of a ``torch.distributed`` group and
gathers the lists on process 0 (:mod:`lkpy_tpu_torch.batch.distributed`).
"""

from lkpy_tpu_torch.batch.results import BatchResults
from lkpy_tpu_torch.batch.runner import BatchPipelineRunner, InvocationSpec

__all__ = ["BatchPipelineRunner", "BatchResults", "InvocationSpec", "predict", "recommend", "score"]


def recommend(pipeline, users, n=None, *, queries=None, n_jobs=None, device=True, mesh=None, distributed=False, **kwargs):
    """Batch-recommend for a set of users (reference: batch/__init__.py).

    With ``device=True`` (the default), a standard top-N pipeline over an
    embedding-family scorer serves the whole batch at once on the device
    where the scorer's tables lie, which is where ``Pipeline.train`` put
    them (the card unless ``TrainingOptions(device="cpu")``); other
    pipelines, and ``device=False``, run per query.  ``device`` is the JAX
    package's switch of route, not a torch device.  ``mesh`` splits each
    block of users over the mesh's ``data`` slots; ``distributed=True``
    additionally splits the users across processes and gathers the lists
    on process 0, None elsewhere (:mod:`lkpy_tpu_torch.batch.distributed`,
    the reference's Ray fan-out analog)."""
    from lkpy_tpu_torch.data import ItemListCollection

    if device and queries is None and not isinstance(users, ItemListCollection):
        flat = _flatten_user_ids(users)
        if flat is not None:
            # the flattening consumed a one-pass iterable (a generator,
            # ``split.test.keys()``): the runner below takes the IDs
            users = flat
            if distributed:
                from lkpy_tpu_torch.batch.device import supports_device_batch
                from lkpy_tpu_torch.batch.distributed import distributed_recommend

                scorer = pipeline.node("scorer").component
                lookup = pipeline.node("history-lookup").component
                if supports_device_batch(scorer) and lookup.interactions is not None:
                    return distributed_recommend(scorer, flat, n if n is not None else 10, lookup.interactions, mesh=mesh)
            from lkpy_tpu_torch.batch.device import try_device_recommend

            fast = try_device_recommend(pipeline, flat, n, mesh=mesh, exact=kwargs.get("exact"))
            if fast is not None:
                return fast
    runner = BatchPipelineRunner(n_jobs=n_jobs)
    runner.recommend(n=n)
    res = runner.run(pipeline, users if queries is None else queries)
    return res.output("recommendations")


def _flatten_user_ids(users):
    """Normalize a user-query sequence to a flat ID array for the device
    batch path; returns None when the inputs need per-query handling
    (RecQuery objects, mappings with candidate lists, ...).  Accepts plain
    IDs and single-field key tuples (e.g. ``split.test.keys()``)."""
    from collections.abc import Mapping

    import numpy as np

    if isinstance(users, Mapping):
        # Mapping inputs carry per-query candidate lists in the values;
        # list(users) would silently drop them — take the runner path.
        return None
    try:
        seq = list(users)
    except TypeError:
        return None
    flat = []
    for u in seq:
        if isinstance(u, tuple):
            if len(u) != 1:
                return None
            u = u[0]
        elif hasattr(u, "_fields"):  # namedtuple key
            vals = tuple(u)
            if len(vals) != 1:
                return None
            u = vals[0]
        if isinstance(u, np.generic):
            u = u.item()
        if not isinstance(u, (int, str, np.integer)):
            return None
        flat.append(u)
    return np.asarray(flat)


def predict(pipeline, pairs, *, n_jobs=None, **kwargs):
    """Batch rating prediction for user-item pairs (reference: batch/__init__.py)."""
    runner = BatchPipelineRunner(n_jobs=n_jobs)
    runner.predict()
    res = runner.run(pipeline, pairs)
    return res.output("predictions")


def score(pipeline, pairs, *, n_jobs=None, **kwargs):
    """Batch scoring for user-item pairs (reference: batch/__init__.py)."""
    runner = BatchPipelineRunner(n_jobs=n_jobs)
    runner.score()
    res = runner.run(pipeline, pairs)
    return res.output("scores")
