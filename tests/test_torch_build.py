"""``ops/_build.py::load`` under threads, on the CPU.

``_compile`` (which runs ``nvcc``) is replaced by a slow stub that counts
its calls and ``ctypes.CDLL`` by a stub that hands out a fresh object: two
threads that ask for one kernel at once must build it once and get the same
library, and two different kernels must still build side by side.
"""

import sys
import threading
import time

import pytest

from lkpy_tpu_torch.ops import _build


@pytest.fixture
def stubbed(monkeypatch, tmp_path):
    calls: list[str] = []
    active = [0, 0]  # now, most at once
    guard = threading.Lock()

    def slow_compile(name):
        with guard:
            calls.append(name)
            active[0] += 1
            active[1] = max(active[1], active[0])
        time.sleep(0.2)
        with guard:
            active[0] -= 1
        return tmp_path / f"lib{name}.so"

    monkeypatch.setattr(_build, "_compile", slow_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_locks", {})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield calls, active
    finally:
        sys.setswitchinterval(interval)


def _load_all(names):
    out = [None] * len(names)
    barrier = threading.Barrier(len(names))

    def work(i):
        barrier.wait(timeout=10)
        out[i] = _build.load(names[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(names))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return out


def test_two_threads_build_one_kernel_once(stubbed):
    calls, _ = stubbed
    libs = _load_all(["spd_solve", "spd_solve"])
    assert calls == ["spd_solve"]
    assert libs[0] is not None and libs[0] is libs[1]
    assert _build.load("spd_solve") is libs[0] and calls == ["spd_solve"]


def test_many_threads_one_build_per_kernel(stubbed):
    calls, active = stubbed
    names = ["gather_gram", "gather_rows", "mips_topk"] * 4
    libs = _load_all(names)
    assert sorted(calls) == ["gather_gram", "gather_rows", "mips_topk"]
    for name in set(names):
        assert len({id(lib) for n, lib in zip(names, libs) if n == name}) == 1
    # different kernels are not held behind one another's build
    assert active[1] >= 2
