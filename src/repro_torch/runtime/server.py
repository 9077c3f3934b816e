"""Server side of the cross-process runtime: a :class:`SocketBackend` that
hands dispatched slots to worker processes over the length-prefixed
transport (``repro.runtime.server``'s counterpart; the frames are the same
bytes, so a worker of either package can serve a server of the other).

Protocol (worker-initiated request/response over a persistent connection):

    pull  {worker}                → work {index, client, version, local_steps,
                                          stream_state} + trees {params,
                                          residual?, rng?}
                                  | wait {}    (no grantable slot right now)
                                  | done {}    (run finished — exit)
    push  {index, client, loss, stream_state} + trees {payload, residual?}
                                  → ack {index}

Fault tolerance:

* **Leases.** A granted slot carries a wall-clock lease; past
  ``lease_timeout`` the next pull (from any worker) re-grants it. The same
  worker re-pulling its own unexpired lease is re-granted too (a dropped
  ``work`` answer must not wedge the slot).
* **Idempotent redispatch.** Assignments are pure, so racing workers return
  identical results; the first push wins, duplicates are acked and dropped.
* **Data cursors.** The server owns every client's stream state: it rides
  out in the assignment and back in the push, and is committed only when the
  driver processes the result in event order.

Snapshots: a slot's params snapshot is framed when a worker pulls it, on the
connection's thread — one device-to-host copy per leaf straight into the
frame, on that thread's current stream (the default stream, behind the
kernels that produced the snapshot). Nothing in the package writes a params
tensor in place, so the snapshot the frame reads is the version it was
dispatched with; a re-granted slot is framed again. Received payloads and
residual rows land on ``device``.

The backend decides nothing about federation: admission, staleness, flushes
and checkpoints stay in :class:`~repro_torch.runtime.driver.FederationDriver`.
"""
from __future__ import annotations

import copy
import socket
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs.tracer import get_tracer
from repro_torch.runtime.chaos import ChaosConfig, ChaosMonkey
from repro_torch.runtime.driver import Assignment, ClientBackend, ClientResult
from repro_torch.runtime.transport import (
    FrameClock,
    Message,
    TransportError,
    recv_msg,
    send_msg,
)
from repro_torch.tree import tree_leaves


class SocketBackend(ClientBackend):
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        stream_states: Optional[List[Dict[str, Any]]] = None,
        lease_timeout: float = 30.0,
        io_timeout: float = 30.0,
        chaos: Optional[ChaosConfig] = None,
        tracer=None,
        device="cpu",
    ):
        self.lease_timeout = lease_timeout
        self.io_timeout = io_timeout
        self.stream_states = stream_states  # index = population client id
        self.device = torch.device(device)
        self.tracer = get_tracer(tracer)
        self.clock = FrameClock()  # host seconds spent framing, all connections
        self._monkey = (
            ChaosMonkey(chaos, "server", tracer=self.tracer)
            if chaos is not None and chaos.active
            else None
        )
        # wire truth: bytes of accepted (non-duplicate) push payloads, and the
        # workers' last-seen clocks for the liveness gauge — plain host floats,
        # safe to read from the metrics HTTP thread
        self.payload_bytes_rx = 0.0
        self._worker_seen: Dict[str, float] = {}
        self._knobs: Dict[str, float] = {}  # live control knobs (control_* gauges)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: Dict[int, Assignment] = {}  # index → live assignment
        self._leases: Dict[int, tuple] = {}  # index → (deadline, worker)
        self._results: Dict[int, ClientResult] = {}  # arrived, not yet processed
        self._done = False
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self.host, self.port = self._srv.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="runtime-accept", daemon=True
        )
        self._accept_thread.start()

    # --- ClientBackend ----------------------------------------------------
    def submit(self, a: Assignment) -> None:
        if self.stream_states is not None:
            a.stream_state = copy.deepcopy(self.stream_states[a.client])
        with self._cv:
            self._pending[a.index] = a
            self._cv.notify_all()

    def result(self, index: int, timeout: Optional[float] = None) -> ClientResult:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while index not in self._results:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"slot {index} still outstanding")
                    self._cv.wait(min(remaining, 0.5))
                else:
                    self._cv.wait(0.5)
            return self._results[index]

    def commit(self, index: int, result: ClientResult) -> None:
        with self._cv:
            self._pending.pop(index, None)
            self._leases.pop(index, None)
            self._results.pop(index, None)
        if self.stream_states is not None and result.stream_state is not None:
            self.stream_states[result.client] = result.stream_state

    def apply_knob_update(self, update, acfg) -> None:
        """Make the live knob values observable as ``control_*`` gauges;
        workers need no notice (assignments are self-describing)."""
        with self._lock:
            self._knobs["control_staleness_alpha"] = float(acfg.staleness_alpha)
            self._knobs["control_buffer_size"] = float(acfg.buffer_size)
        if self.tracer.enabled:
            self.tracer.count("knob_updates_applied")

    def control_knobs(self) -> Dict[str, float]:
        """Current server-side control knob values (empty when uncontrolled)."""
        with self._lock:
            return dict(self._knobs)

    def metrics_extras(self) -> Dict[str, float]:
        """The metrics endpoint's extras: worker liveness and the live knobs."""
        return {**self.worker_liveness(), **self.control_knobs()}

    def finish(self) -> None:
        """Start answering every pull with ``done`` (run complete)."""
        with self._cv:
            self._done = True
            self._cv.notify_all()

    def close(self, linger: float = 0.0) -> None:
        self.finish()
        if linger > 0:  # give workers a beat to pull the "done" answer
            time.sleep(linger)
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=2.0)

    # --- socket plumbing --------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(self.io_timeout)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._serve, args=(conn,), name="runtime-conn", daemon=True
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                msg = recv_msg(conn, tracer=self.tracer, device=self.device, clock=self.clock)
                if msg.type == "pull":
                    self._handle_pull(conn, msg)
                elif msg.type == "push":
                    self._handle_push(conn, msg)
                else:
                    send_msg(conn, "error", {"reason": f"unknown type {msg.type}"},
                             tracer=self.tracer)
        except (TransportError, OSError):
            pass  # worker went away; its leases expire and redispatch
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _grant(self, worker: str) -> Optional[Assignment]:
        now = time.monotonic()
        with self._lock:
            for index in sorted(self._pending):
                if index in self._results:
                    continue  # computed, waiting for in-order processing
                lease = self._leases.get(index)
                if lease is not None and lease[0] > now and lease[1] != worker:
                    continue  # actively leased to someone else
                regrant = lease is not None
                expired = regrant and lease[0] <= now
                self._leases[index] = (now + self.lease_timeout, worker)
                if self.tracer.enabled:
                    self.tracer.point(
                        "lease_grant", parent=f"d{index}", index=index,
                        worker=worker, regrant=regrant, expired=expired,
                    )
                    self.tracer.count("lease_grants")
                    if expired:
                        self.tracer.count("lease_expiries")
                        self.tracer.count("redispatches")
                    elif regrant:
                        self.tracer.count("lease_regrants")
                return self._pending[index]
        return None

    def _handle_pull(self, conn: socket.socket, msg: Message) -> None:
        worker = str(msg.meta.get("worker", "?"))
        self._worker_seen[worker] = time.monotonic()
        self.tracer.count("pulls")
        if self._done:
            send_msg(conn, "done", chaos=self._monkey, tracer=self.tracer, clock=self.clock)
            return
        a = self._grant(worker)
        if a is None:
            self.tracer.count("pull_waits")
            send_msg(conn, "wait", chaos=self._monkey, tracer=self.tracer, clock=self.clock)
            return
        meta = {
            "index": a.index,
            "client": a.client,
            "version": a.version,
            "local_steps": a.local_steps,
            "stream_state": a.stream_state,
        }
        if self.tracer.enabled:
            # the worker parents its assignment span into this dispatch's span
            meta["trace"] = {"t": self.tracer.trace_id, "s": f"d{a.index}"}
        trees = {"params": a.params}
        if a.residual is not None:
            trees["residual"] = a.residual
        if a.rng is not None:
            trees["rng"] = a.rng
        send_msg(conn, "work", meta=meta, trees=trees, chaos=self._monkey, tracer=self.tracer,
                 clock=self.clock)

    def _handle_push(self, conn: socket.socket, msg: Message) -> None:
        index = int(msg.meta["index"])
        worker = str(msg.meta.get("worker", "?"))
        self._worker_seen[worker] = time.monotonic()
        result = ClientResult(
            index=index,
            client=int(msg.meta["client"]),
            payload=msg.trees.get("payload"),
            residual=msg.trees.get("residual"),
            loss=float(msg.meta["loss"]),
            stream_state=msg.meta.get("stream_state"),
        )
        with self._cv:
            # first result wins; duplicates (lease races, a re-push after a
            # dropped ack) are acked and dropped — they are identical anyway
            accepted = index in self._pending and index not in self._results
            if accepted:
                self._results[index] = result
                self._cv.notify_all()
        if self.tracer.enabled:
            self.tracer.point("push_recv", parent=f"d{index}", index=index,
                              worker=worker, dup=not accepted)
            self.tracer.count("pushes")
            if accepted:
                if result.payload is not None:
                    nbytes = float(sum(x.numel() * x.element_size()
                                       for x in tree_leaves(result.payload)))
                    self.payload_bytes_rx += nbytes
                    self.tracer.count("payload_bytes_rx", nbytes)
            else:
                self.tracer.count("dedup_drops")
        send_msg(conn, "ack", {"index": index}, chaos=self._monkey, tracer=self.tracer,
                 clock=self.clock)

    # --- liveness ---------------------------------------------------------
    def worker_liveness(self, window: float = 15.0) -> Dict[str, float]:
        """Workers seen within ``window`` seconds and every worker ever seen
        (plain floats, for the metrics HTTP thread)."""
        now = time.monotonic()
        seen = dict(self._worker_seen)
        return {
            "workers_alive": float(sum(1 for t in seen.values() if now - t <= window)),
            "workers_seen": float(len(seen)),
        }

    # --- checkpoint support ----------------------------------------------
    def snapshot_stream_states(self) -> Optional[List[Dict[str, Any]]]:
        """Data cursors as of every processed event (commit order), consistent
        with the aggregator's dispatch manifest by construction."""
        if self.stream_states is None:
            return None
        return copy.deepcopy(self.stream_states)
