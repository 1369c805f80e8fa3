"""Sizes at which a cell runs on the CPU in seconds: the same code as on the
card, a small data set and small requests."""

import time

import torch

TINY = {
    "config": {
        "data": {"n_users": 120, "n_items": 300, "n_pairs": 5000, "max_per_user": 150, "item_max": 110, "item_median": 8},
    },
    "traffic": {"users_per_request": 32, "in_flight": 2, "check_requests": 2},
}

WORKLOADS = ["als-implicit-ml20m.train", "als-implicit-ml20m.serve"]


def run_tiny(workload: str, *, seed: int = 2147483711, trace: bool = False, control: bool = False, seconds: float = 1.0) -> dict:
    from portbench.core.cell import run_cell

    return run_cell(workload, seed, seconds, trace, torch.device("cpu"), t_start=time.perf_counter(), overrides=TINY, control=control)
