"""
LightGCN of the program (``lkpy_tpu_torch.models.lightgcn.LightGCNScorer``)
under the benchmark, and its plain reference (:mod:`portbench.reference.
lightgcn`).

Training only: the trainer of ``create_trainer`` on the whole set, started
from Xavier-uniform tables that the benchmark draws on the card from the
seed (given with ``load_parameters``).  A step is one ``train_step()``: a
mini-batch of positives with one verified negative each, the propagation of
both tables through every layer over every edge, forward and backward, and
one Adam step.  The first steps are watched through that same call: the
batch each took (``last_batch``), its loss and the tables after it; of the
first, the propagated tables it used and the ego tables' gradients.  The
reference repeats the steps on the same draws from the same start.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from portbench.core.compare import relative_gap
from portbench.reference import lightgcn as ref

__all__ = ["Watched", "train_build", "train_capture", "train_compare", "train_counters", "train_reference", "train_step", "train_work"]


@dataclass
class Watched:
    """The program's trainer and the list that the watched steps' draws go to
    (the start's ``draws``, which the reference reads)."""

    trainer: object
    draws: list


def _settings(cfg: dict) -> dict:
    return dict(cfg["model"]["settings"])


def _xavier(n: int, k: int, gen: torch.Generator, device) -> torch.Tensor:
    """An ``(n, k)`` table uniform on ±sqrt(6 / (n + k)) (Glorot & Bengio 2010)."""
    bound = math.sqrt(6.0 / (n + k))
    return (2.0 * torch.rand((n, k), generator=gen, device=device) - 1.0) * bound


def train_build(cfg, ds, inter, seed: int, device, gen):
    """The program's trainer and the start both sides take."""
    from lkpy_tpu_torch.models.flexmf import FlexMFTrainerBase
    from lkpy_tpu_torch.models.lightgcn import LightGCNScorer
    from lkpy_tpu_torch.training import TrainingOptions

    if not hasattr(FlexMFTrainerBase, "train_step"):
        raise RuntimeError("the program's gradient trainer has no train_step(): a LightGCN cell cannot step it")
    k = cfg["model"]["settings"]["embedding_size"]
    trainer = LightGCNScorer(_settings(cfg)).create_trainer(ds, TrainingOptions(rng=seed, device=device))
    start = {"u_embed": _xavier(inter.n_users, k, gen, device), "i_embed": _xavier(inter.n_items, k, gen, device), "draws": []}
    trainer.load_parameters({name: start[name].clone() for name in ("u_embed", "i_embed")})
    return Watched(trainer, start["draws"]), start


def train_step(run: Watched) -> None:
    run.trainer.train_step()


def _tables(trainer) -> tuple[torch.Tensor, torch.Tensor]:
    p = trainer.whole_params()
    return p["u_embed"].detach().clone(), p["i_embed"].detach().clone()


def train_capture(run: Watched, steps: int) -> list:
    """The first ``steps`` steps, through the window's own call: each
    step's loss and the tables' change since the start; the first step's
    propagated tables (as its ``step_embeds`` returned them) and the ego
    tables' gradients (``.grad``, which the step leaves in place).  The
    batches go to ``run.draws``."""
    t = run.trainer
    u0, i0 = _tables(t)
    seen = []
    orig = t.step_embeds

    def watched_embeds():
        embeds = orig()
        seen.append(tuple(e.detach().clone() for e in embeds))
        return embeds

    out = []
    for s in range(steps):
        if s == 0:
            t.step_embeds = watched_embeds
        try:
            loss = t.train_step()
        finally:
            if s == 0:
                del t.step_embeds
        run.draws.append(tuple(c.clone() for c in t.last_batch))
        u, i = _tables(t)
        rec = {"loss": loss, "u_delta": u - u0, "i_delta": i - i0}
        if s == 0:
            p = t.params
            rec.update(u_eff=seen[0][0], i_eff=seen[0][1], u_grad=p["u_embed"].grad.clone(), i_grad=p["i_embed"].grad.clone())
        out.append(rec)
    return out


def train_work(run: Watched, inter) -> int:
    """Interactions a step: the batch's positives."""
    return int(run.trainer.last_batch[0].shape[0])


def train_reference(cfg, inter, start: dict, steps: int, precision: str) -> list:
    """The reference's first ``steps`` steps from ``start`` on the program's
    draws, in the same records as :func:`train_capture`'s; each also holds
    ``negative_hits``, how many of the draws' negatives are positives of
    their user (the reference's own exact test)."""
    s = cfg["model"]["settings"]
    g = ref.Graph(inter.users, inter.items, inter.n_users, inter.n_items)
    draws = start["draws"][:steps]
    hits = sum(int(g.contains(users, neg).sum()) for users, _, neg in draws)
    u0, i0 = start["u_embed"].double(), start["i_embed"].double()
    out = []
    for j, r in enumerate(ref.train(g, u0, i0, draws, s["layer_count"], s["regularization"] or 0.0, s["learning_rate"], precision)):
        rec = {"loss": r["loss"], "u_delta": r["u_embed"] - u0, "i_delta": r["i_embed"] - i0, "negative_hits": hits}
        if j == 0:
            rec.update({k: r[k] for k in ("u_eff", "i_eff", "u_grad", "i_grad")})
        out.append(rec)
    return out


def train_compare(captured: list, reference: list) -> dict:
    """The comparison's numbers (relative Frobenius gaps, the worst of the
    two tables): the first step's propagated tables and ego gradients, the
    tables' change over the watched steps, the worst relative gap of a
    step's loss, and the watched negatives that are positives."""
    first_c, first_r, last_c, last_r = captured[0], reference[0], captured[-1], reference[-1]

    def gap(a, b, names):
        return max(relative_gap(a[n], b[n]) for n in names)

    return {
        "lgcn_embed_err": gap(first_c, first_r, ("u_eff", "i_eff")),
        "lgcn_grad_err": gap(first_c, first_r, ("u_grad", "i_grad")),
        "lgcn_update_err": gap(last_c, last_r, ("u_delta", "i_delta")),
        "lgcn_loss_err": max(abs(float(c["loss"]) - float(r["loss"])) / abs(float(r["loss"])) for c, r in zip(captured, reference)),
        "lgcn_negative_hits": float(first_r["negative_hits"]),
    }


def train_counters(cfg, run: Watched, inter) -> dict:
    """The shapes the per-layer readers need: the edges of one sparse
    product, the tables' rows, k, the layers and the batch."""
    s = cfg["model"]["settings"]
    return {
        "edges": inter.nnz,
        "n_rows": inter.n_users + inter.n_items,
        "k": s["embedding_size"],
        "layers": s["layer_count"],
        "batch": train_work(run, inter),
    }
