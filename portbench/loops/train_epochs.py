"""
Training, a step after another: the traffic mix's ``loop = "train_epochs"``.

Set-up draws the data set from the seed, builds the program's ``Dataset``
and the family's trainer, and drives the trainer through its first
``watched_steps`` steps (the warm-up), which the family watches for the
check.  The window then calls the same trainer's step back to back until
``seconds`` have passed, and ends in a synchronize.  The rate is the
family's work of every step completed in the window over the window's
seconds; the configuration's ``train_metric`` names it.
"""

from __future__ import annotations

import time

import torch

from portbench.core.cell import Cell, Outcome, host_clocks, sub_seed
from portbench.core.data import make_interactions, summary
from portbench.core.program import build_dataset
from portbench.core.trace import wrap_spans

__all__ = ["check", "run"]


def run(cell: Cell, t_start: float) -> Outcome:
    cfg, fam, dev = cell.cfg, cell.fam, cell.device
    t = time.perf_counter()
    cell.setup["imports"] = t - t_start
    inter = make_interactions(cfg["data"], sub_seed(cell.seed, 1), dev)
    t = cell.part("data", t)
    cell.reset_peak()
    ds = build_dataset(inter)
    t = cell.part("dataset", t)
    trainer, start = fam.train_build(cfg, ds, inter, sub_seed(cell.seed, 5), dev, cell.gen(2))
    t = cell.part("trainer", t)
    steps = cell.mix["watched_steps"]
    captured = fam.train_capture(trainer, steps)
    t = cell.part("warmup", t)
    cell.setup["total"] = t - t_start
    work = fam.train_work(trainer, inter)
    counters = dict(fam.train_counters(cfg, trainer, inter))

    tracer = cell.tracer
    with wrap_spans(tracer, cell.mix.get("spans", [])), host_clocks() as host_clock:
        tracer.start()
        t0 = time.perf_counter()
        done = 0
        while time.perf_counter() - t0 < cell.seconds:
            with tracer.span("step"):
                fam.train_step(trainer)
            done += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        trace = tracer.stop()
    counters.update(steps=done, window_s=elapsed, host=host_clock, data=summary(inter))
    values = {cfg["train_metric"]: work * done / elapsed}
    del trainer
    return Outcome(values, done, 0, counters, trace, {"inter": inter, "start": start, "captured": captured, "steps": steps})


def check(cell: Cell, state: dict, control: str | None = None) -> tuple[dict, dict | None]:
    """The comparison's numbers: the family's, of the watched steps against
    the reference's from the same start; and with ``control`` (a lower
    precision) the same numbers of the reference in that precision put in
    the program's place."""
    fam, cfg = cell.fam, cell.cfg
    inter, start, captured, steps = state["inter"], state["start"], state["captured"], state["steps"]
    reference = fam.train_reference(cfg, inter, start, steps, "float64")
    numbers = fam.train_compare(captured, reference)
    if control is None:
        return numbers, None
    lower = fam.train_reference(cfg, inter, start, steps, control)
    return numbers, fam.train_compare(lower, reference)
