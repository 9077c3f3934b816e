"""Client worker process: pull → local training → push, until the server says
done (``repro.runtime.worker``'s counterpart).

A worker is pure compute. The assignment carries the params snapshot, the
version, the error-feedback row, the per-dispatch codec key and the client's
data cursor; the worker loads the cursor into its (identically built) stream,
draws the τ local batches, runs the shared client phase
(``runtime.driver.build_client_phase``, the call the in-process driver makes)
on ``device`` and pushes back the encoded payload, the updated row, the
advanced cursor and the last train loss. With ``--fused-server`` and a fused
codec, the encode is the codec's CUDA kernel on the card (``int8_quant`` once
per executed assignment under ``--uplink int8``).

Any worker can serve any client, and executing an assignment again gives the
same result: the server's lease redispatch relies on that.

Failure discipline: every pull and push is a request/response with an I/O
timeout; a transport failure (refused, reset, EOF, timeout, a chaos-dropped
frame) closes the connection and retries under bounded exponential backoff
(:class:`~repro_torch.runtime.transport.Backoff`); the worker exits when the
server answers ``done`` or stays unreachable past the backoff's budget.
"""
from __future__ import annotations

import socket
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.compression import Codec
from repro_torch.core.federated import FederatedConfig
from repro_torch.core.sampler import ParticipationConfig
from repro_torch.obs.tracer import get_tracer
from repro_torch.runtime.chaos import ChaosConfig, ChaosMonkey
from repro_torch.runtime.driver import build_client_phase, execute_assignment
from repro_torch.runtime.transport import (
    Backoff,
    FrameClock,
    Message,
    TransportError,
    connect,
    recv_msg,
    send_msg,
)


class _Dropped(TransportError):
    """Our own outbound frame was chaos-dropped — retry like any other loss."""


class ClientWorker:
    def __init__(
        self,
        loss_fn: Callable,
        fed: FederatedConfig,
        pcfg: ParticipationConfig,
        *,
        streams: Optional[List[Any]] = None,  # one TokenStream per population client
        batch_size: int = 1,
        make_batches: Optional[Callable[[int], Any]] = None,  # pure-in-cid override
        host: str = "127.0.0.1",
        port: int = 0,
        codec: Optional[Codec] = None,
        name: str = "worker",
        io_timeout: float = 30.0,
        poll_interval: float = 0.05,
        backoff: Optional[Backoff] = None,
        chaos: Optional[ChaosConfig] = None,
        tracer=None,
        device="cuda",
    ):
        if (streams is None) == (make_batches is None):
            raise ValueError("pass exactly one of streams= or make_batches=")
        self.fed = fed
        self.streams = streams
        self.make_batches = make_batches
        self.batch_size = batch_size
        self.host, self.port = host, port
        self.name = name
        self.io_timeout = io_timeout
        self.poll_interval = poll_interval
        self.backoff = backoff or Backoff()
        self.device = resolve_device(device)
        self._stateful = codec is not None and codec.stateful
        self._codec = codec
        self._partial = pcfg.partial_progress
        self._client_fn = build_client_phase(loss_fn, fed, codec, pcfg.partial_progress)
        self.tracer = get_tracer(tracer)
        self.clock = FrameClock()  # host seconds spent framing
        self.n_client_phases = 0  # assignments executed (one codec encode each)
        self._monkey = (
            ChaosMonkey(chaos, name, tracer=self.tracer)
            if chaos is not None and chaos.active
            else None
        )
        self._sock: Optional[socket.socket] = None

    # --- transport with retry --------------------------------------------
    def _close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _rpc(self, mtype: str, meta: Dict[str, Any], trees=None) -> Optional[Message]:
        """One request/response with reconnect and bounded exponential
        backoff; None when the server stayed unreachable past the budget."""
        while True:
            try:
                if self._sock is None:
                    self._sock = connect(self.host, self.port, self.io_timeout)
                if not send_msg(self._sock, mtype, meta, trees, chaos=self._monkey,
                                tracer=self.tracer, clock=self.clock):
                    raise _Dropped("chaos dropped our frame")
                reply = recv_msg(self._sock, tracer=self.tracer, device=self.device,
                                 clock=self.clock)
                self.backoff.reset()
                return reply
            except (TransportError, OSError) as e:
                self._close()
                if not self.backoff.sleep():
                    print(f"[{self.name}] giving up: {e}", flush=True)
                    return None

    # --- the work loop ----------------------------------------------------
    def run(self, max_assignments: Optional[int] = None) -> int:
        """Serve until the server says done (or goes away); the number of
        assignments completed."""
        done = 0
        while max_assignments is None or done < max_assignments:
            reply = self._rpc("pull", {"worker": self.name})
            if reply is None or reply.type == "done":
                break
            if reply.type == "wait":
                time.sleep(self.poll_interval)
                continue
            if reply.type != "work":
                continue
            index = int(reply.meta["index"])
            # parent into the server's dispatch span via the wire-propagated
            # context (the deterministic id when the server runs untraced)
            wire_trace = reply.meta.get("trace") or {}
            parent = wire_trace.get("s", f"d{index}")
            sid = f"d{index}@{self.name}"
            self.tracer.begin(
                "assignment", span_id=sid, parent=parent, index=index,
                client=int(reply.meta["client"]), version=int(reply.meta["version"]),
            )
            with self.tracer.span("train", span_id=f"{sid}/t", parent=sid):
                meta, trees = self._execute(reply)
            if self._monkey is not None:
                # corruption after training, before framing: the CRC passes and
                # only the server's screen or robust rule stands in the way
                trees["payload"], _ = self._monkey.on_payload(trees["payload"], index)
            self.tracer.begin("push", span_id=f"{sid}/p", parent=sid)
            ack = self._rpc("push", meta, trees)
            self.tracer.end(f"{sid}/p", ok=ack is not None)
            self.tracer.end(sid, outcome="pushed" if ack is not None else "gave_up")
            self.tracer.count("assignments")
            if ack is None:
                break
            done += 1
        self._close()
        self.tracer.flush()
        return done

    def _draw(self, cid: int, stream_state):
        """τ local batches for ``cid`` from the shipped data cursor (real
        streams) or a pure-in-cid batch function; ``(batches, new_cursor)``."""
        if self.streams is None:
            return self.make_batches(cid), None
        from repro_torch.data import round_batches

        stream = self.streams[cid]
        if stream_state is not None:
            stream.load_state_dict(stream_state)
        batches = {k: torch.from_numpy(v).to(self.device)
                   for k, v in round_batches([stream], self.fed.local_steps,
                                             self.batch_size).items()}
        return batches, stream.state_dict()

    def _execute(self, msg: Message):
        meta = msg.meta
        cid = int(meta["client"])
        batches, new_cursor = self._draw(cid, meta.get("stream_state"))
        self.n_client_phases += 1
        payload, residual, loss = execute_assignment(
            self._client_fn, self.fed, self._partial, self._stateful, msg.trees["params"],
            int(meta["version"]), batches,
            rng=msg.trees["rng"] if self._codec is not None else None,
            residual=msg.trees.get("residual"), local_steps=int(meta["local_steps"]))
        out_meta = {
            "index": int(meta["index"]),
            "client": cid,
            "loss": loss,
            "stream_state": new_cursor,
            "worker": self.name,
        }
        out_trees: Dict[str, Any] = {"payload": payload}
        if self._stateful:
            out_trees["residual"] = residual
        return out_meta, out_trees
