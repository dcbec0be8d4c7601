"""Networked measurement service: tracker + measure servers + runner (a
copy of ``vae_extent_search_tpu/search/measure_service.py``; the wire
format is the same, so a runner of either package talks to a tracker or
server of the other).

Parity target: the reference's RPC measurement topology
(measure.py:434-611 ``RPCRunner`` / ``LocalRPCMeasureContext`` over the
tvm.rpc tracker+server): a *tracker* match-makes device keys to
registered *servers*; the search requests a device by key per batch and
times candidates remotely — used both for real remote fleets and for
local process isolation.

A server's timing backend is any ``Runner``: the deterministic analytic
simulator, a record replayer, or the ``CommandRunner`` external-timer
bridge on a box that has the target toolchain. The wire format is the
v0.6-bit-compatible record log both sides already speak, over
newline-delimited JSON on TCP:

- server -> tracker: ``{"op": "register", "key": K, "addr": [h, p]}``
- runner -> tracker: ``{"op": "request", "key": K}`` ->
  ``{"addr": [h, p]}`` (round-robin over live servers; dead servers are
  evicted on connection failure)
- runner -> server:  ``{"records": [<record lines>], "timeout": s}`` ->
  ``{"costs": [float | "error", ...]}`` in input order

``ServiceRunner`` plugs into ProgramMeasurer like every other Runner:
timeouts and refused connections degrade to error-carrying
MeasureResults (reference timeout semantics), never exceptions.
``LocalServiceMeasureContext`` mirrors LocalRPCMeasureContext: it
spawns an in-process tracker + server pair for isolation-style use.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import List, Optional, Tuple

from ..records.serde import record_from_json, record_to_json
from .measure import (
    ERROR_NO_ERROR,
    ERROR_RUNTIME_DEVICE,
    MAX_FLOAT,
    MeasureResult,
    Runner,
    make_record,
)


def _send_json(sock: socket.socket, obj) -> None:
    sock.sendall((json.dumps(obj) + "\n").encode())


def _recv_json(sock: socket.socket, timeout: Optional[float] = None):
    # the timeout bounds the WHOLE response, not each recv — a peer
    # trickling bytes must not stall a runner past the deadline
    deadline = None if timeout is None else time.monotonic() + timeout
    buf = b""
    while not buf.endswith(b"\n"):
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("response deadline exceeded")
            sock.settimeout(remaining)
        else:
            sock.settimeout(None)
        chunk = sock.recv(1 << 20)
        if not chunk:
            break
        buf += chunk
    return json.loads(buf.decode()) if buf.strip() else None


class MeasureTracker:
    """Match-maker: device key -> registered server addresses
    (round-robin; eviction by the requesting side on failure)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    req = json.loads(self.rfile.readline().decode())
                except Exception:
                    return
                if req.get("op") == "register":
                    with outer._lock:
                        servers = outer._servers.setdefault(
                            req["key"], [])
                        addr = tuple(req["addr"])
                        if addr not in servers:
                            servers.append(addr)
                    self.wfile.write(b'{"ok": true}\n')
                elif req.get("op") == "request":
                    with outer._lock:
                        servers = outer._servers.get(req["key"], [])
                        if servers:
                            outer._rr[req["key"]] = (
                                outer._rr.get(req["key"], -1) + 1)
                            addr = servers[
                                outer._rr[req["key"]] % len(servers)]
                        else:
                            addr = None
                    self.wfile.write(
                        (json.dumps({"addr": addr}) + "\n").encode())
                elif req.get("op") == "evict":
                    with outer._lock:
                        servers = outer._servers.get(req["key"], [])
                        addr = tuple(req["addr"])
                        if addr in servers:
                            servers.remove(addr)
                    self.wfile.write(b'{"ok": true}\n')

        self._servers = {}
        self._rr = {}
        self._lock = threading.Lock()
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), Handler)
        self._srv.daemon_threads = True
        self.addr: Tuple[str, int] = self._srv.server_address
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


class MeasureServer:
    """Times record batches with a local Runner backend and serves the
    results (the reference's rpc server + its timing method)."""

    def __init__(self, runner: Runner, key: str = "default",
                 tracker_addr: Optional[Tuple[str, int]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    req = json.loads(self.rfile.readline().decode())
                except Exception:
                    return
                costs = []
                for line in req.get("records", []):
                    try:
                        rec = record_from_json(line)
                        st = rec.inp.recover_state(infer_bound=True)
                        res = outer.runner.run(rec.inp.task, [st])[0]
                        if res.error_no != ERROR_NO_ERROR:
                            costs.append("error")
                        else:
                            costs.append(float(res.costs[0]))
                    except Exception:
                        costs.append("error")
                self.wfile.write(
                    (json.dumps({"costs": costs,
                                 "key": outer.key}) + "\n").encode())

        self.runner = runner
        self.key = key
        self._srv = socketserver.ThreadingTCPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.addr: Tuple[str, int] = self._srv.server_address
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        if tracker_addr is not None:
            self.register(tracker_addr)

    def register(self, tracker_addr: Tuple[str, int]) -> None:
        with socket.create_connection(tracker_addr, timeout=10) as s:
            _send_json(s, {"op": "register", "key": self.key,
                           "addr": list(self.addr)})
            _recv_json(s, timeout=10)

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


class ServiceRunner(Runner):
    """Runner that measures through the tracker/server service
    (reference RPCRunner surface: key + tracker host/port + timeout).
    Server-side or transport failures map to error_no results; a dead
    server is evicted from the tracker and the batch retried once on
    the next server."""

    def __init__(self, key: str, host: str, port: int,
                 timeout: float = 60.0, n_retry: int = 1):
        self.key = key
        self.tracker_addr = (host, port)
        self.timeout = timeout
        self.n_retry = n_retry

    def _request_server(self) -> Optional[Tuple[str, int]]:
        try:
            with socket.create_connection(self.tracker_addr,
                                          timeout=self.timeout) as s:
                _send_json(s, {"op": "request", "key": self.key})
                resp = _recv_json(s, timeout=self.timeout)
            addr = resp and resp.get("addr")
            return tuple(addr) if addr else None
        except Exception:
            return None

    def _evict(self, addr: Tuple[str, int]) -> None:
        try:
            with socket.create_connection(self.tracker_addr,
                                          timeout=self.timeout) as s:
                _send_json(s, {"op": "evict", "key": self.key,
                               "addr": list(addr)})
                _recv_json(s, timeout=self.timeout)
        except Exception:
            pass

    def run(self, task, states) -> List[MeasureResult]:
        now = time.time()
        lines = [
            record_to_json(make_record(
                task, st.transform_steps, [0.0], 0, 0.0, now))
            for st in states
        ]
        costs = None
        for _ in range(1 + self.n_retry):
            addr = self._request_server()
            if addr is None:
                break
            conn = None
            for attempt in (0, 1):
                try:
                    conn = socket.create_connection(addr,
                                                    timeout=self.timeout)
                    break
                except OSError:
                    if attempt == 0:
                        time.sleep(0.2)  # transient blip ≠ dead server
            if conn is None:
                # unreachable twice: evict and try the next one — a
                # SLOW batch must not kill a healthy server, so only
                # connect failures evict (servers register once; a
                # single local blip must not drain fleet capacity)
                self._evict(addr)
                continue
            try:
                with conn as s:
                    _send_json(s, {"records": lines,
                                   "timeout": self.timeout})
                    resp = _recv_json(s, timeout=self.timeout)
                costs = resp["costs"]
                break
            except Exception:
                # transport/timeout mid-batch: error results for this
                # batch; the server stays registered
                break
        out = []
        for i in range(len(states)):
            c = costs[i] if costs and i < len(costs) else "error"
            if isinstance(c, (int, float)):
                out.append(MeasureResult([float(c)], ERROR_NO_ERROR,
                                         float(c), time.time()))
            else:
                out.append(MeasureResult([MAX_FLOAT],
                                         ERROR_RUNTIME_DEVICE, 0.0,
                                         time.time()))
        return out


class LocalServiceMeasureContext:
    """Spawn a local tracker + one server around a Runner backend —
    the reference's LocalRPCMeasureContext (measure.py:520-611) without
    the process isolation it needed for CUDA state (our backends are
    pure). Use as a context manager; ``.runner`` is the plug-in for
    ProgramMeasurer/TuningOptions."""

    def __init__(self, backend: Optional[Runner] = None,
                 key: str = "local", timeout: float = 60.0):
        from .measure import AnalyticRunner

        self.tracker = MeasureTracker()
        self.server = MeasureServer(
            backend or AnalyticRunner(noise=0.2), key=key,
            tracker_addr=self.tracker.addr)
        self.runner = ServiceRunner(key, *self.tracker.addr,
                                    timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self.server.close()
        self.tracker.close()
