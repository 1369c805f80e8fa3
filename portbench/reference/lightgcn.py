"""
LightGCN, plainly (He, Deng, Wang, Li, Zhang & Wang, "LightGCN: Simplifying
and Powering Graph Convolution Network for Recommendation", SIGIR 2020,
arXiv:2002.02126, eqs. 3, 4 and 6 of §3.1 and the BPR loss of §3.2).

The graph is the bipartite interaction graph with symmetric normalisation:
an edge (u, i) carries ``1 / sqrt(|N_u| · |N_i|)``.  A layer maps the
tables ``(E_u, E_i)`` to ``(Â E_i, Âᵀ E_u)``; the final tables blend the
``K + 1`` layer outputs with ``α_k = 1/(K+1)``.  A step takes the BPR loss
``−mean log σ(e_u·e_p − e_u·e_n)`` over the batch plus
``λ · ½ · Σ‖e⁰‖² / B`` over the batch's user, positive and negative ego rows,
its gradient, and one Adam step (β 0.9 and 0.999, ε 1e-8, bias-corrected)
over both whole tables.

Written out, not taken by autograd:

* a product is ``index_add_`` of ``value · row`` over the edges, in chunks
  of :data:`EDGE_CHUNK` edges so that it fits at 20 M edges;
* the propagation is linear and ``[[0, Â], [Âᵀ, 0]]`` is symmetric, so the
  gradient with respect to the ego tables is the same blended propagation
  applied to the loss's gradient with respect to the final tables, plus the
  L2 term's.

Departures from the paper, all shared with the program under test: the
batch's users, positives and negatives are the program's own draws (one
uniform negative a positive, which the program verified), taken here as
given; the start tables are given; the L2 term divides by the batch's size
as the program's does (the paper's code divides by it too).

``precision`` is ``float64`` (the reference) or ``bfloat16``, the control:
float64 arithmetic with every layer's output rounded to bfloat16, the
precision of a bf16 adjacency route.  The module imports nothing of the
program and sets TF32 off while it trains (and back as it found it).
"""

from __future__ import annotations

import torch

__all__ = ["Graph", "adam", "propagate", "step", "train"]

#: edges gathered at once: 2 M × k = 64 float64 is 1 GiB
EDGE_CHUNK = 1 << 21

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class Graph:
    """The normalised edges, user-major: rows, columns and values."""

    def __init__(self, users: torch.Tensor, items: torch.Tensor, n_users: int, n_items: int):
        self.rows, self.cols = users.long(), items.long()
        self.n_users, self.n_items = n_users, n_items
        deg_u = torch.bincount(self.rows, minlength=n_users).clamp_min(1).double()
        deg_i = torch.bincount(self.cols, minlength=n_items).clamp_min(1).double()
        self.vals = torch.rsqrt(deg_u[self.rows] * deg_i[self.cols])

    def contains(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """Whether each pair ``(users[j], items[j])`` is an edge, exactly."""
        keys = self.rows * self.n_items + self.cols
        keys = torch.sort(keys).values
        want = users.long() * self.n_items + items.long()
        pos = torch.searchsorted(keys, want).clamp_(max=keys.shape[0] - 1)
        return keys[pos] == want


def _product(vals, src_idx, dst_idx, src, n_dst):
    out = torch.zeros((n_dst, src.shape[1]), dtype=src.dtype, device=src.device)
    for lo in range(0, vals.shape[0], EDGE_CHUNK):
        hi = lo + EDGE_CHUNK
        out.index_add_(0, dst_idx[lo:hi], vals[lo:hi, None] * src[src_idx[lo:hi]])
    return out


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float64)
    raise ValueError(f"unknown precision {precision!r}")


def propagate(g: Graph, u: torch.Tensor, i: torch.Tensor, layers: int, precision: str):
    """The blended tables ``Σ_k α_k (E_u^k, E_i^k)`` from ego tables ``u``, ``i``."""
    alpha = 1.0 / (layers + 1)
    u_acc, i_acc = alpha * u, alpha * i
    for _ in range(layers):
        u, i = (
            _round(_product(g.vals, g.cols, g.rows, i, g.n_users), precision),
            _round(_product(g.vals, g.rows, g.cols, u, g.n_items), precision),
        )
        u_acc = u_acc + alpha * u
        i_acc = i_acc + alpha * i
    return u_acc, i_acc


def step(g: Graph, u0, i0, users, pos, neg, layers: int, reg: float, precision: str) -> dict:
    """One step's loss, propagated tables and ego gradients from ego tables
    ``u0``, ``i0`` (float64) on the batch ``(users, pos, neg)``."""
    users, pos, neg = users.long(), pos.long(), neg.long()
    B = users.shape[0]
    eu, ei = propagate(g, u0, i0, layers, precision)
    ue, pe, ne = eu[users], ei[pos], ei[neg]
    x = (ue * pe).sum(1) - (ue * ne).sum(1)
    l2 = (u0[users].square().sum() + i0[pos].square().sum() + i0[neg].square().sum()) / B
    loss = -torch.nn.functional.logsigmoid(x).mean() + reg * 0.5 * l2
    # d loss / d x_b = −σ(−x_b) / B
    d = (-torch.sigmoid(-x) / B)[:, None]
    gu = torch.zeros_like(eu).index_add_(0, users, d * (pe - ne))
    gi = torch.zeros_like(ei).index_add_(0, pos, d * ue).index_add_(0, neg, -d * ue)
    gu0, gi0 = propagate(g, gu, gi, layers, precision)
    gu0 = gu0.index_add_(0, users, (reg / B) * u0[users])
    gi0 = gi0.index_add_(0, pos, (reg / B) * i0[pos]).index_add_(0, neg, (reg / B) * i0[neg])
    return {"loss": loss, "u_eff": eu, "i_eff": ei, "u_grad": gu0, "i_grad": gi0}


def adam(p: torch.Tensor, grad: torch.Tensor, state: dict, lr: float) -> torch.Tensor:
    """One bias-corrected Adam step of ``p``; ``state`` holds ``m``, ``v``, ``t``."""
    t = state["t"] = state.get("t", 0) + 1
    m = state["m"] = BETA1 * state.get("m", torch.zeros_like(p)) + (1 - BETA1) * grad
    v = state["v"] = BETA2 * state.get("v", torch.zeros_like(p)) + (1 - BETA2) * grad * grad
    m_hat = m / (1 - BETA1**t)
    v_hat = v / (1 - BETA2**t)
    return p - lr * m_hat / (torch.sqrt(v_hat) + EPS)


def train(g: Graph, u0, i0, batches: list, layers: int, reg: float, lr: float, precision: str) -> list:
    """Steps from ego tables ``u0``, ``i0`` over ``batches`` of
    ``(users, pos, neg)``; for each, its :func:`step` and the tables after it."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        u, i = u0.double(), i0.double()
        su, si, out = {}, {}, []
        for users, pos, neg in batches:
            s = step(g, u, i, users, pos, neg, layers, reg, precision)
            u, i = adam(u, s["u_grad"], su, lr), adam(i, s["i_grad"], si, lr)
            out.append(s | {"u_embed": u, "i_embed": i})
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
