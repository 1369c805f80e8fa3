"""The port's task records, logging set-up, rate-limited warnings and the
latch, against the JAX package where both have them.

A record saved by one package is read by the other: ``Task`` keeps the JAX
package's field names, ``tpu_power`` included.  Energy comes from a meter
registered in both packages (no RAPL or Prometheus source is read here).
"""

import json
import logging
import threading
import time
import warnings

import pytest

import lkpy_tpu.logging.power as jax_power
import lkpy_tpu_torch.logging.power as power
from lkpy_tpu.logging import LoggingConfig as JaxLoggingConfig
from lkpy_tpu.logging import Task as JaxTask
from lkpy_tpu.logging.limit import RateLimitedWarnings as JaxRateLimited
from lkpy_tpu.utils.misc import indent_lines as jax_indent_lines
from lkpy_tpu_torch.diagnostics import DataWarning
from lkpy_tpu_torch.logging import LoggingConfig, Task, Tracer, basic_logging, get_logger, max_memory, reset_linux_hwm
from lkpy_tpu_torch.logging.limit import RateLimitedWarnings, filter_duplicate_warnings
from lkpy_tpu_torch.logging.logger import TRACE_LEVEL
from lkpy_tpu_torch.logging.resource import cpu_times
from lkpy_tpu_torch.utils.misc import Latch, indent_lines


@pytest.fixture
def root_logging():
    """Restore the root logger's level and handlers after a test applies a config."""
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    yield root
    for h in list(root.handlers):
        if h not in handlers:
            h.close()
        root.removeHandler(h)
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


@pytest.fixture
def meters():
    """The same cumulative counter in both packages: one Joule a read, per scope."""
    reads = {"system": 0.0, "cpu": 100.0, "tpu": 7.0}

    def meter(scope):
        reads[scope] += 1.0
        return reads[scope]

    power.register_energy_meter(meter)
    jax_power.register_energy_meter(meter)
    yield
    power.register_energy_meter(None)
    jax_power.register_energy_meter(None)


def test_task_fields_equal_jax():
    assert list(Task.model_fields) == list(JaxTask.model_fields)
    assert "tpu_power" in Task.model_fields


def test_task_nesting_and_record(tmp_path, meters):
    with Task("outer", file=tmp_path / "outer.json") as outer:
        assert Task.current() is outer
        with Task("inner") as inner:
            assert Task.current() is inner
            time.sleep(0.01)
        assert Task.current() is outer
    assert Task.current() is None
    assert [t.label for t in outer.subtasks] == ["inner"]
    assert outer.status == inner.status == "finished"
    assert outer.duration >= inner.duration > 0
    assert outer.cpu_time is not None and 0 < outer.peak_memory <= max_memory()
    # each scope read twice by the inner task: one Joule between them
    assert inner.system_power == inner.cpu_power == inner.tpu_power == 1.0
    saved = json.loads((tmp_path / "outer.json").read_text())
    assert set(saved) == set(JaxTask.model_fields)
    assert saved["subtasks"][0]["label"] == "inner"


def test_task_failed_status():
    with pytest.raises(ValueError):
        with Task("boom") as t:
            raise ValueError("x")
    assert t.status == "failed" and t.finish_time is not None


def test_task_records_cross_packages(tmp_path, meters):
    with Task("port", file=tmp_path / "port.json") as t:
        with Task("child"):
            pass
    with JaxTask("jax", file=tmp_path / "jax.json") as j:
        with JaxTask("child"):
            pass
    by_jax = JaxTask.load(tmp_path / "port.json")
    by_port = Task.load(tmp_path / "jax.json")
    assert by_jax.model_dump() == t.model_dump()
    assert by_port.model_dump() == j.model_dump()
    assert Task.load(tmp_path / "port.json").model_dump() == t.model_dump()


def test_task_without_meter_leaves_accelerator_energy_empty():
    with Task("plain") as t:
        pass
    # no meter for the accelerator scope and no Prometheus configured
    assert t.tpu_power is None and t.system_power is None
    assert power.measure_energy("tpu", 1.0) is None


def test_rapl_meter_reads_zones(tmp_path):
    for i, uj in enumerate((1_500_000, 2_500_000)):
        zone = tmp_path / f"intel-rapl:{i}"
        zone.mkdir()
        (zone / "energy_uj").write_text(str(uj))
    meter, jax_meter = power.RaplMeter(tmp_path), jax_power.RaplMeter(tmp_path)
    assert meter.available and meter("cpu") == jax_meter("cpu") == pytest.approx(4.0)
    assert meter("tpu") is None
    assert not power.RaplMeter(tmp_path / "absent").available


@pytest.mark.parametrize("verbose", [0, 1, 2])
def test_logging_config_set_verbose(verbose):
    lc, jc = LoggingConfig(), JaxLoggingConfig()
    lc.set_verbose(verbose)
    jc.set_verbose(verbose)
    assert lc.level == jc.level == [logging.INFO, logging.DEBUG, TRACE_LEVEL][verbose]


def test_logging_config_apply_and_file(tmp_path, root_logging):
    lc = LoggingConfig()
    lc.set_verbose(1)
    lc.log_file(tmp_path / "run.log", level=logging.INFO)
    lc.apply()
    assert root_logging.level == logging.DEBUG
    files = [h for h in root_logging.handlers if isinstance(h, logging.FileHandler)]
    assert len(files) == 1 and files[0].level == logging.INFO
    get_logger("lkpy_tpu_torch.test").info("hello", k=1)
    get_logger("lkpy_tpu_torch.test").debug("not in the file")
    files[0].flush()
    text = (tmp_path / "run.log").read_text()
    assert "hello k=1" in text and "not in the file" not in text


def test_logging_config_json_file(tmp_path, root_logging):
    lc = LoggingConfig()
    lc.log_file(tmp_path / "run.jsonl", json=True)
    lc.apply()
    get_logger("lkpy_tpu_torch.test").warning("event", n=2)
    for h in root_logging.handlers:
        h.flush()
    rec = json.loads((tmp_path / "run.jsonl").read_text().splitlines()[-1])
    assert rec["level"] == "WARNING" and rec["event"] == "event n=2" and rec["name"] == "lkpy_tpu_torch.test"


def test_basic_logging_level(root_logging):
    basic_logging(logging.WARNING)
    assert root_logging.level == logging.WARNING
    assert len(root_logging.handlers) == 1


def test_tracer_binds(caplog):
    from lkpy_tpu_torch.logging import activate_tracing

    tr = Tracer(get_logger("lkpy_tpu_torch.trace"))
    tr.add_bindings(node="scorer")
    with caplog.at_level(TRACE_LEVEL):
        tr.trace("silent")
        activate_tracing(True)
        try:
            tr.trace("running")
        finally:
            activate_tracing(False)
    msgs = [r.getMessage() for r in caplog.records]
    assert "running node=scorer" in msgs and not any(m.startswith("silent") for m in msgs)


def test_rate_limited_warnings():
    for cls in (RateLimitedWarnings, JaxRateLimited):
        rl = cls(window=60.0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(5):
                rl.warn("same thing", DataWarning)
            rl.warn("another thing")
        assert [str(w.message) for w in caught] == ["same thing", "another thing"]
        assert caught[0].category is DataWarning
        rl = cls(window=0.0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rl.warn("again")
            rl.warn("again")
        assert len(caught) == 2


def test_filter_duplicate_warnings():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        filter_duplicate_warnings()
        for _ in range(3):
            warnings.warn("dup", DataWarning)
    assert len(caught) == 1


def test_latch_releases_waiters():
    latch = Latch(3)
    released = []

    def waiter():
        released.append(latch.wait(timeout=10))

    threads = [threading.Thread(target=waiter) for _ in range(4)]
    for t in threads:
        t.start()
    assert not latch.wait(timeout=0.01)
    for _ in range(3):
        latch.count_down()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert released == [True] * 4
    latch.count_down()
    assert latch.wait(timeout=0)


def test_indent_lines_and_resources():
    assert indent_lines("a\nb") == jax_indent_lines("a\nb") == "  a\n  b"
    assert indent_lines("a", "> ") == "> a"
    u, s = cpu_times()
    assert u >= 0 and s >= 0
    reset_linux_hwm()
    assert max_memory() > 0
