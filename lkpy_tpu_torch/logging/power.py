"""
Energy/power measurement for task tracking (port of
``lkpy_tpu/logging/power.py``).

Counterpart of the reference's Prometheus power scrape (reference:
src/lenskit/logging/tasks.py:434 ``measure_power``): tasks record estimated
energy (Joules) per scope.  The scopes keep the JAX package's names; the
``tpu`` scope is the accelerator's and has no meter of its own here, so it
stays ``None`` on a GPU unless a meter is registered.  Sources, tried in
order:

1. a registered meter (:func:`register_energy_meter` — tests, site plugins);
2. Linux powercap/RAPL counters (``/sys/class/powercap``) for the CPU scope;
3. a Prometheus HTTP query configured via ``[prometheus]`` in ``lkpy-tpu.toml``
   (reference parity; gated — zero-egress environments simply return None).

All sources are best-effort: failures return ``None`` and never raise into
the task path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Literal

__all__ = ["measure_energy", "register_energy_meter", "EnergySnapshot", "RaplMeter"]

Scope = Literal["system", "cpu", "tpu"]

# meter(scope) -> cumulative Joules, or None if the scope is unsupported
_meter: "Callable[[str], float | None] | None" = None


def register_energy_meter(meter: "Callable[[str], float | None] | None") -> None:
    """Install (or clear, with ``None``) a process-wide cumulative energy
    meter; it overrides RAPL/Prometheus lookup."""
    global _meter
    _meter = meter


class RaplMeter:
    """Cumulative CPU energy from Linux powercap RAPL counters (µJ files)."""

    def __init__(self, root: Path | str = "/sys/class/powercap"):
        self.root = Path(root)
        self._zones = sorted(self.root.glob("intel-rapl:?")) if self.root.exists() else []

    @property
    def available(self) -> bool:
        return bool(self._zones)

    def __call__(self, scope: str) -> float | None:
        if scope != "cpu" or not self._zones:
            return None
        total = 0.0
        for zone in self._zones:
            try:
                total += int((zone / "energy_uj").read_text()) * 1e-6
            except OSError:
                return None
        return total


_rapl = RaplMeter()


class EnergySnapshot:
    """Cumulative meter readings at a point in time; subtract two snapshots
    for per-task Joules."""

    def __init__(self):
        self.readings: dict[str, float] = {}
        for scope in ("system", "cpu", "tpu"):
            val = _read_cumulative(scope)
            if val is not None:
                self.readings[scope] = val

    def delta(self, other: "EnergySnapshot") -> dict[str, float]:
        out = {}
        for scope, end in self.readings.items():
            start = other.readings.get(scope)
            if start is not None and end >= start:
                out[scope] = end - start
        return out


def _read_cumulative(scope: str) -> float | None:
    if _meter is not None:
        try:
            return _meter(scope)
        except Exception:
            return None
    if scope == "cpu" and _rapl.available:
        return _rapl("cpu")
    return None


def measure_energy(scope: Scope, duration_s: float) -> float | None:
    """One-shot energy estimate over a trailing window (Prometheus-style
    rate query; reference: tasks.py:434).  Used when no cumulative counter
    exists; returns Joules or None."""
    cfg = _prometheus_config()
    if cfg is None:
        return None
    url, queries = cfg
    query = queries.get(scope)
    if not query:
        return None
    try:
        import urllib.parse
        import urllib.request

        q = query.format(elapsed=int(duration_s * 1000))
        full = url.rstrip("/") + "/api/v1/query?" + urllib.parse.urlencode({"query": q})
        import json

        with urllib.request.urlopen(full, timeout=2) as resp:
            data = json.loads(resp.read())
        results = data.get("data", {}).get("result", [])
        if results:
            return float(results[0]["value"][1]) * duration_s
    except Exception:
        return None
    return None


def _prometheus_config():
    from lkpy_tpu_torch.config import lkpy_tpu_config

    prom = lkpy_tpu_config().prometheus
    if not prom.url:
        return None
    return prom.url, dict(prom.power_queries)
