"""
Implicit ALS of the program (``lkpy_tpu_torch.models.als.ImplicitMFScorer``)
under the benchmark, and its plain reference (:mod:`portbench.reference.
als_implicit`).

Training: the trainer of ``create_trainer`` on the whole set, started from
factor tables that the benchmark draws on the card from the seed (the
port's own start, ``(0.01 z)²``).  A step is one ``train_epoch()``: both
halves, normal equations by G, solves by B1, the rows scattered back.  The
first steps are compared table by table with the reference's epochs from the
same start.

Serving: the scorer built from an item table drawn from the seed, every user
folded in from their history (G and B2) on each request.
"""

from __future__ import annotations

import torch

from portbench.core.compare import relative_gap
from portbench.reference import als_implicit as ref

__all__ = ["serve_build", "serve_scores", "serve_work", "train_build", "train_capture", "train_compare", "train_reference", "train_step"]

#: the program's functions that traced serving runs wrap in spans
SERVE_SPANS = [["lkpy_tpu_torch.models.als", "_fold_implicit_kernel", "fold_in"]]


def _settings(cfg: dict) -> dict:
    return dict(cfg["model"]["settings"])


def train_build(cfg, ds, inter, seed: int, device, gen):
    """The program's trainer and the start both sides take."""
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.training import TrainingOptions

    k = cfg["model"]["settings"]["embedding_size"]
    scorer = ImplicitMFScorer(_settings(cfg))
    trainer = scorer.create_trainer(ds, TrainingOptions(rng=seed, device=device))
    start = {
        "user_factors": torch.square(0.01 * torch.randn((inter.n_users, k), generator=gen, device=device)),
        "item_factors": torch.square(0.01 * torch.randn((inter.n_items, k), generator=gen, device=device)),
    }
    trainer.load_parameters({k: v.clone() for k, v in start.items()})
    return trainer, start


def train_step(trainer) -> None:
    trainer.train_epoch()


def train_capture(trainer, steps: int) -> list:
    """The first ``steps`` epochs, through the window's own call; the
    tables after each."""
    out = []
    for _ in range(steps):
        trainer.train_epoch()
        out.append({"user_factors": trainer.u_factors.clone(), "item_factors": trainer.i_factors.clone()})
    return out


def train_work(trainer, inter) -> int:
    """Interactions an epoch: each training interaction once."""
    return inter.nnz


def train_reference(cfg, inter, start: dict, steps: int, precision: str) -> list:
    """The reference's first ``steps`` epochs from ``start``."""
    s = cfg["model"]["settings"]
    users_csr = ref.csr(inter.users, inter.items, inter.n_users)
    items_csr = ref.csr(inter.items, inter.users, inter.n_items)
    U, V = start["user_factors"], start["item_factors"]
    out = []
    for _ in range(steps):
        U, V = ref.epoch(users_csr, items_csr, U, V, s["regularization"], s["weight"], precision)
        out.append({"user_factors": U, "item_factors": V})
    return out


def train_compare(captured: list, reference: list) -> dict:
    """``als_table_err``: the worst relative Frobenius gap of a table after
    any of the compared epochs."""
    worst = max(relative_gap(c[k], r[k]) for c, r in zip(captured, reference) for k in ("user_factors", "item_factors"))
    return {"als_table_err": worst}


def serve_build(cfg, ds, inter, device, gen):
    """The scorer and the tables the reference takes: item and user tables
    of ``0.1 z``; ``_OtOr`` is worked out by the program's own function."""
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.ops.als import implicit_otor

    s = cfg["model"]["settings"]
    k = s["embedding_size"]
    V = 0.1 * torch.randn((inter.n_items, k), generator=gen, device=device)
    U = 0.1 * torch.randn((inter.n_users, k), generator=gen, device=device)
    params = {"user_embeddings": U, "item_embeddings": V, "_OtOr": implicit_otor(V, s["regularization"])}
    scorer = ImplicitMFScorer.from_numpy(params, _settings(cfg), ds.users, ds.items, device=device)
    return scorer, {"item_embeddings": V}


def serve_scores(cfg, inter, tables: dict, users: torch.Tensor, precision: str) -> torch.Tensor:
    """The reference's scores of every item for ``users``, each folded in
    from their history."""
    s = cfg["model"]["settings"]
    users_csr = ref.csr(inter.users, inter.items, inter.n_users)
    vecs = ref.fold_in(users_csr, users, tables["item_embeddings"], s["regularization"], s["weight"], precision)
    return ref.scores(vecs, tables["item_embeddings"], precision)


def serve_work(cfg, entries: int, rows: int, n_items: int) -> dict:
    """Operations a request needs and the kernels' least times: fold-in
    (G over the history entries, B2 a row) and the score product."""
    from portbench.roofline import counts

    k = cfg["model"]["settings"]["embedding_size"]
    g = counts.bound_s(counts.gram_ops(entries, k), counts.gram_bytes(entries, rows, k))
    b2 = counts.bound_s(counts.solve_ops(rows, k), counts.solve_bytes(rows, k))
    ops = counts.gram_ops(entries, k) + counts.solve_ops(rows, k) + counts.matmul_ops(rows, k, n_items)
    return {"ops": ops, "G_bound_s": g, "B2_bound_s": b2}


def train_counters(cfg, trainer, inter) -> dict:
    """Work a step (an epoch, both halves) for the per-layer readers:
    entries seen by G, rows solved by B1."""
    return {"entries_per_step": 2 * inter.nnz, "rows_per_step": inter.n_users + inter.n_items, "k": cfg["model"]["settings"]["embedding_size"]}
