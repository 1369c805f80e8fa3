"""
Multi-process runtime initialization.

Port of ``lkpy_tpu/parallel/distributed.py`` (reference:
src/lenskit/parallel/ray.py:65, logging/multiprocess/_monitor.py): the
JAX package starts ``jax.distributed``; the port starts a
``torch.distributed`` process group.  What the port does across processes
is the batch-inference query split and the gather of its pickled results
(:mod:`lkpy_tpu_torch.batch.distributed`), so the group is gloo: it carries
Python objects, and unlike NCCL it takes several processes on one card.
On a single host without configuration this is a no-op.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from lkpy_tpu_torch.logging import get_logger

_log = get_logger(__name__)

__all__ = [
    "init_distributed",
    "setup_log_relay",
    "is_coordinator",
    "host_count",
    "host_index",
    "local_device_count",
    "object_group",
]

_object_group = None


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """
    Initialize the multi-process runtime (idempotent).

    ``coordinator_address`` is ``host:port`` of process 0; with no arguments
    it reads torchrun's variables (``MASTER_ADDR`` and ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  Without a coordinator or a process count
    this is a no-op returning False.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if addr is None and num_processes is None:
        return False
    try:
        if addr is None or num_processes is None or process_id is None:
            raise ValueError("a process group needs the coordinator's address, the process count and this process's rank")
        dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=num_processes, rank=process_id)
        _log.info("distributed runtime initialized", process=host_index(), n_processes=host_count())
        setup_log_relay()
        return True
    except (RuntimeError, ValueError) as e:
        _log.warning("distributed init failed; running single-host", error=str(e))
        return False


def object_group():
    """A gloo process group for gathering Python objects: the default group
    where it is gloo, else one made once over every process (gloo carries
    CPU tensors, whatever backend the caller chose for the default)."""
    global _object_group
    if dist.get_backend() == "gloo":
        return None
    if _object_group is None:
        _object_group = dist.new_group(backend="gloo")
    return _object_group


def setup_log_relay(address: str | None = None, key_hex: str | None = None) -> object | None:
    """
    Hook up the multi-process log relay (reference's ZMQ monitor role,
    src/lenskit/logging/multiprocess/_monitor.py:111): process 0 binds the
    singleton :class:`~lkpy_tpu_torch.logging.multiprocess.Monitor` on a TCP
    endpoint and the other processes forward their log records to it, so a
    run has one consolidated log stream on process 0.

    Configured by ``LKT_LOG_RELAY=tcp://host:port`` + ``LKT_LOG_RELAY_KEY``
    (hex auth key, shared out-of-band — typically the job launcher exports
    both on every host).  No-op (returns None) when unconfigured or
    single-process.  The processes wait for each other once, so every
    worker finds the monitor bound.
    """
    address = address or os.environ.get("LKT_LOG_RELAY")
    key_hex = key_hex or os.environ.get("LKT_LOG_RELAY_KEY")
    if not address or not key_hex or host_count() < 2:
        return None
    key = bytes.fromhex(key_hex)
    import lkpy_tpu_torch.logging.multiprocess as mp

    if host_index() == 0:
        try:
            with mp._monitor_lock:
                if mp._monitor is None:
                    mp._monitor = mp.Monitor(address=address, auth_key=key)
        finally:
            # the workers wait here whether or not the bind succeeded
            dist.barrier(group=object_group())
        _log.info("log relay monitor bound", address=address)
        return mp._monitor
    dist.barrier(group=object_group())
    ctx = mp.WorkerContext(address, key)
    ctx.install_handler()
    _log.info("log relay worker attached", address=address)
    return ctx


def is_coordinator() -> bool:
    """True on process 0 (log aggregation / checkpoint writer role)."""
    return host_index() == 0


def host_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_device_count() -> int:
    return torch.cuda.device_count()
