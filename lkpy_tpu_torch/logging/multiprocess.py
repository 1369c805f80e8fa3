"""
Multiprocess log relay.

Port of ``lkpy_tpu/logging/multiprocess.py`` (reference:
src/lenskit/logging/multiprocess/_monitor.py:111,233 ``Monitor`` +
``MonitorThread``, _worker.py:93 ``WorkerContext``, the blake2b-signed
protocol of _protocol.py:17): worker processes, on this host or another,
forward log messages and records to a singleton monitor thread in the
coordinating process.

The transport is the standard library's sockets where the JAX package uses
ZMQ PUSH/PULL: a frame is the payload's length (4 bytes, big-endian), its
16-byte blake2b signature under the shared key, then the JSON payload.
Addresses are ``tcp://host:port`` (port 0 picks a free one; the bound
address is the monitor's ``address``) or ``ipc:///path/to/socket``.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import os
import secrets
import selectors
import socket
import struct
import threading
from typing import Any

__all__ = ["Monitor", "WorkerContext", "get_monitor", "shutdown_monitor"]

_monitor: "Monitor | None" = None
_monitor_lock = threading.Lock()

_HEADER = struct.Struct("!I")
_SIG_BYTES = 16
#: largest payload a monitor accepts; a longer frame closes its connection
MAX_PAYLOAD = 16 << 20


def _sign(key: bytes, payload: bytes) -> bytes:
    return hashlib.blake2b(payload, key=key, digest_size=_SIG_BYTES).digest()


def _endpoint(address: str) -> tuple[int, Any]:
    """(socket family, socket address) of a ``tcp://`` or ``ipc://`` address."""
    if address.startswith("tcp://"):
        host, _, port = address[len("tcp://") :].rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad tcp address {address!r}; expected tcp://host:port")
        return socket.AF_INET, (host.strip("[]"), int(port))
    if address.startswith("ipc://"):
        return socket.AF_UNIX, address[len("ipc://") :]
    raise ValueError(f"unsupported relay address {address!r}; expected tcp://host:port or ipc://path")


class Monitor:
    """Singleton monitor collecting log messages and records from workers
    (reference: _monitor.py:111)."""

    def __init__(self, address: str | None = None, auth_key: bytes | None = None):
        """Bind to ``address`` (default: a free TCP port on the loopback
        interface; pass a ``tcp://host:port`` endpoint for a cross-host
        relay) with ``auth_key`` (default: random; share it with remote
        workers out-of-band, e.g. the LKT_LOG_RELAY_KEY env var)."""
        family, where = _endpoint(address or "tcp://127.0.0.1:0")
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(where)
        self._sock.listen()
        self._sock.setblocking(False)
        if family == socket.AF_INET:
            host, port = self._sock.getsockname()[:2]
            self.address = f"tcp://{host}:{port}"
        else:
            self.address = f"ipc://{where}"
        self.auth_key = auth_key if auth_key is not None else secrets.token_bytes(32)
        self.record_sinks: dict[str, Any] = {}
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._sock, selectors.EVENT_READ, None)
        self._shutdown = threading.Event()
        self._thread = threading.Thread(target=self._run, name="lkt-monitor", daemon=True)
        self._thread.start()

    def add_record_sink(self, sink, sink_id: str | None = None):
        sid = sink_id or str(id(sink))
        self.record_sinks[sid] = sink
        return sid

    def remove_record_sink(self, sink_id: str):
        self.record_sinks.pop(sink_id, None)

    def _run(self):
        while not self._shutdown.is_set():
            for key, _ in self._selector.select(timeout=0.2):
                if key.data is None:
                    try:
                        conn, _ = self._sock.accept()
                    except (BlockingIOError, InterruptedError):
                        continue
                    conn.setblocking(False)
                    self._selector.register(conn, selectors.EVENT_READ, bytearray())
                else:
                    self._read(key.fileobj, key.data)
        for key in list(self._selector.get_map().values()):
            key.fileobj.close()
        self._selector.close()

    def _read(self, conn: socket.socket, buf: bytearray):
        try:
            chunk = conn.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            chunk = b""
        if not chunk:
            self._selector.unregister(conn)
            conn.close()
            return
        buf += chunk
        while len(buf) >= _HEADER.size + _SIG_BYTES:
            (n,) = _HEADER.unpack_from(buf)
            if n > MAX_PAYLOAD:
                logging.getLogger(__name__).warning("dropping a monitor connection that sent an oversized frame")
                self._selector.unregister(conn)
                conn.close()
                return
            end = _HEADER.size + _SIG_BYTES + n
            if len(buf) < end:
                return
            sig = bytes(buf[_HEADER.size : _HEADER.size + _SIG_BYTES])
            payload = bytes(buf[_HEADER.size + _SIG_BYTES : end])
            del buf[:end]
            self._receive(sig, payload)

    def _receive(self, sig: bytes, payload: bytes):
        if not hmac.compare_digest(sig, _sign(self.auth_key, payload)):
            logging.getLogger(__name__).warning("dropping unauthenticated monitor message")
            return
        try:
            msg = json.loads(payload)
        except json.JSONDecodeError:  # pragma: no cover
            return
        self._dispatch(msg)

    def _dispatch(self, msg: dict):
        kind = msg.get("kind")
        if kind == "log":
            logger = logging.getLogger(msg.get("name", "worker"))
            logger.log(msg.get("level", logging.INFO), "[worker %s] %s", msg.get("pid"), msg.get("event"))
        elif kind == "record":
            for sink in list(self.record_sinks.values()):
                sink.record(msg.get("data", {}))

    def shutdown(self):
        self._shutdown.set()
        self._thread.join(timeout=2)
        self._sock.close()
        if self.address.startswith("ipc://"):
            try:
                os.unlink(self.address[len("ipc://") :])
            except FileNotFoundError:
                pass


def get_monitor() -> Monitor:
    """The process-wide monitor, started on first use (reference: _monitor.py ``get_monitor``)."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = Monitor()
        return _monitor


def shutdown_monitor():
    global _monitor
    with _monitor_lock:
        if _monitor is not None:
            _monitor.shutdown()
            _monitor = None


class WorkerContext:
    """Worker-side log forwarding (reference: _worker.py:93).

    Construct with the monitor's (address, auth_key) — e.g. shipped to a
    subprocess or another host — then use as a logging.Handler target or
    call :meth:`send_log` / :meth:`send_record` directly.
    """

    def __init__(self, address: str, auth_key: bytes):
        family, where = _endpoint(address)
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        self._sock.connect(where)
        self._key = auth_key
        self._lock = threading.Lock()

    def _send(self, msg: dict):
        payload = json.dumps(msg).encode()
        frame = _HEADER.pack(len(payload)) + _sign(self._key, payload) + payload
        with self._lock:
            self._sock.sendall(frame)

    def send_log(self, name: str, level: int, event: str):
        self._send({"kind": "log", "name": name, "level": level, "event": event, "pid": os.getpid()})

    def send_record(self, data: dict):
        self._send({"kind": "record", "data": data})

    def install_handler(self, level: int = logging.INFO):
        """Install a root logging handler that forwards to the monitor."""
        ctx = self

        class _Fwd(logging.Handler):
            def emit(self, record):
                try:
                    ctx.send_log(record.name, record.levelno, record.getMessage())
                except OSError:  # pragma: no cover - the monitor went away
                    self.handleError(record)

        h = _Fwd(level)
        logging.getLogger().addHandler(h)
        return h

    def close(self):
        with self._lock:
            self._sock.close()
