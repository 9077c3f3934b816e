"""The port's cross-process runtime (``repro_torch.runtime``) on the CPU.

- Frames: the same message through each package's encoder gives the same
  bytes, both ways, with bfloat16 leaves, list and tuple nodes, 0-dim leaves
  and nested meta; each package decodes the other's frame to the same values.
  Truncation, CRC damage, the byte counters, the backoff and the chaos dice.
- The seam: ``FederationDriver`` over ``LocalClientBackend`` is bitwise the
  port's ``AsyncFederationDriver`` (rows, checkpoint tree and manifest).
- Sockets (worker threads on a localhost socket): bitwise the in-process run
  for float32, top-k and the fused int8 codec; an abandoned lease is
  redispatched; a killed and resumed server is bitwise the uninterrupted
  run; deadline flushes; a traced run's byte counters and trace check.
- The CLI: ``--runtime sockets`` refusals in the reference's words, and one
  real run of a server and two worker subprocesses whose rows are the
  in-process CLI's.

Every socket binds port 0, and every join, recv and subprocess has its own
timeout.
"""
import csv
import os
import socket
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest

from torch_parity import jax_flat

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro.launch import train as jt  # noqa: E402
from repro.runtime import ChaosConfig as JChaosConfig  # noqa: E402
from repro.runtime import ChaosMonkey as JChaosMonkey  # noqa: E402
from repro.runtime import transport as JW  # noqa: E402
from repro_torch.core.compression import get_codec  # noqa: E402
from repro_torch.launch import train as tt  # noqa: E402
from repro_torch.obs import JsonlSink, Tracer, check_run, load_run  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    Backoff,
    ChaosConfig,
    ChaosMonkey,
    ClientWorker,
    FederationDriver,
    LocalClientBackend,
    SocketBackend,
    TransportError,
    connect,
    decode_msg,
    encode_msg,
    recv_msg,
    send_msg,
)
from repro_torch.runtime import transport as TW  # noqa: E402
from repro_torch.tree import params_to_numpy, tree_leaves, tree_map  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# the wire format against the reference's
# ---------------------------------------------------------------------------


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "segments": [{"w": rng.standard_normal((2, 3)).astype(np.float32)},
                     {"w": rng.standard_normal((5,)).astype(np.float32)}],
        "pair": (np.arange(3, dtype=np.int8), np.arange(4, dtype=np.int32)),
        "scale": np.asarray(0.25, np.float32),  # 0-dim: goes out as shape [1]
        "empty": np.zeros((0, 3), np.float32),
    }


def _bf16_bits(seed=1):
    return (np.random.default_rng(seed).standard_normal(7) * 3).astype(np.float32)


def _both_trees(seed=0):
    tree, bf = _np_tree(seed), _bf16_bits(seed + 1)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jtree["bf"] = jnp.asarray(bf, jnp.bfloat16)
    ttree = tree_map(lambda x: torch.from_numpy(np.array(x)), tree)
    ttree["bf"] = torch.from_numpy(bf).to(torch.bfloat16)
    return jtree, ttree


META = {"index": 3, "client": 1, "version": 2, "local_steps": 0, "loss": 0.1 + 0.2,
        "stream_state": {"pos": [1, 2], "seed": 7}, "worker": "w0"}


def test_frames_are_the_references_bytes_both_ways():
    jtree, ttree = _both_trees()
    key = jax.random.PRNGKey(11)
    jraw = JW.encode_msg("work", META, {"params": jtree, "rng": key, "residual": None})
    traw = encode_msg("work", META, {"params": ttree, "rng": np.asarray(key), "residual": None})
    assert bytes(traw) == jraw
    # the port decodes the reference's frame, and the reference the port's
    for raw, dec in ((jraw, decode_msg), (bytes(traw), JW.decode_msg)):
        msg = dec(raw)
        assert msg.type == "work" and msg.meta == META
    got, want = decode_msg(jraw), JW.decode_msg(bytes(traw))
    assert isinstance(got.trees["params"]["segments"], list)
    assert isinstance(got.trees["params"]["pair"], tuple)
    assert got.trees["params"]["bf"].dtype == torch.bfloat16
    assert got.trees["rng"].dtype == np.uint32  # PRNG keys stay numpy on the host
    np.testing.assert_array_equal(got.trees["rng"], np.asarray(key))
    for path, leaf in jax_flat(want.trees["params"]).items():
        mine = params_to_numpy(got.trees["params"])[path]
        np.testing.assert_array_equal(mine, leaf, err_msg=path)
        assert mine.shape == leaf.shape, path  # the 0-dim leaf is (1,) on both sides
    # re-encoding what was decoded gives the frame again
    assert bytes(encode_msg(got.type, got.meta, got.trees)) == jraw


@pytest.mark.parametrize("uplink", ["float32", "topk", "bf16", "int8"])
def test_a_pushed_payload_frame_is_the_references(uplink):
    """A push of each codec's payload: the port's payload tree and the same
    numbers as a JAX tree frame to the same bytes, and the int8 payload read
    back from the wire decodes to the sent delta."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((4, 4)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32)]}
    delta = tree_map(lambda x: torch.from_numpy(x * 0.01), params)
    codec = get_codec(uplink, 0.25, fused=True) if uplink != "float32" else None
    payload = (codec.encode(delta, tree_map(torch.zeros_like, delta), rng=T.prng_key(3))[0]
               if codec is not None else delta)
    jpayload = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)
        if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy()), payload)
    meta = {"index": 1, "client": 0, "loss": 0.5, "stream_state": None, "worker": "w1"}
    traw = encode_msg("push", meta, {"payload": payload})
    assert bytes(traw) == JW.encode_msg("push", meta, {"payload": jpayload})
    back = decode_msg(traw).trees["payload"]
    if codec is not None:
        assert params_to_numpy(codec.decode(back)).keys() == params_to_numpy(delta).keys()
        for k, v in params_to_numpy(codec.decode(back)).items():
            np.testing.assert_array_equal(v, params_to_numpy(codec.decode(payload))[k])


def test_truncated_and_corrupted_frames_raise():
    a, b = socket.socketpair()
    try:
        raw = bytes(encode_msg("pull", {"worker": "w0"}))
        frame = len(raw).to_bytes(8, "big") + zlib.crc32(raw).to_bytes(4, "big") + raw
        a.sendall(frame[: len(frame) // 2])
        a.close()
        with pytest.raises(TransportError):
            recv_msg(b)
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        raw = bytearray(encode_msg("push", {"index": 1}, {"payload": torch.ones(3)}))
        frame = len(raw).to_bytes(8, "big") + zlib.crc32(raw).to_bytes(4, "big")
        raw[-1] ^= 0xFF  # one flipped byte in flight
        a.sendall(frame + bytes(raw))
        with pytest.raises(TW.FrameCorruptError):
            recv_msg(b)
    finally:
        a.close()
        b.close()
    with pytest.raises(TransportError, match="truncated inside an array blob"):
        decode_msg(bytes(encode_msg("push", {}, {"payload": torch.ones(4)}))[:-3])


def test_socket_roundtrip_counts_framed_bytes_and_framing_time():
    sender, receiver = Tracer(proc="tx"), Tracer(proc="rx")
    clock_tx, clock_rx = TW.FrameClock(), TW.FrameClock()
    a, b = socket.socketpair()
    try:
        b.settimeout(10.0)
        assert send_msg(a, "push", {"index": 1}, {"payload": torch.ones(3)}, tracer=sender,
                        clock=clock_tx)
        msg = recv_msg(b, tracer=receiver, clock=clock_rx)
        assert msg.meta["index"] == 1 and torch.equal(msg.trees["payload"], torch.ones(3))
    finally:
        a.close()
        b.close()
    tx, rx = sender.snapshot()["counters"], receiver.snapshot()["counters"]
    raw = encode_msg("push", {"index": 1}, {"payload": torch.ones(3)})
    assert tx["bytes_tx"] == rx["bytes_rx"] == len(raw) + 12  # + length prefix + CRC
    assert tx["msgs_tx"] == rx["msgs_rx"] == 1
    assert clock_tx.frames == 1 and clock_rx.frames == 2  # CRC, then the copies out
    assert clock_tx.seconds > 0 and clock_rx.seconds > 0


def test_backoff_is_bounded_and_gives_up():
    bo = Backoff(base=0.001, cap=0.002, give_up_after=0.01)
    results = [bo.sleep() for _ in range(40)]
    assert results[0] is True and results[-1] is False
    bo.reset()
    assert bo.sleep() is True


def test_chaos_dice_are_the_references_per_role():
    for kw in (dict(drop=0.5, delay=0.25, seed=11), dict(kill=0.1, drop=0.2, seed=3)):
        for role in ("server", "w0", "w1"):
            t, j = ChaosMonkey(ChaosConfig(**kw), role), JChaosMonkey(JChaosConfig(**kw), role)
            assert [t._rng.random() for _ in range(16)] == [j._rng.random() for _ in range(16)]
    assert ChaosMonkey(ChaosConfig(drop=1.0), "x").on_send() is True
    assert ChaosMonkey(ChaosConfig(), "x").on_send() is False
    with pytest.raises(ValueError):
        ChaosConfig(drop=1.5)
    with pytest.raises(ValueError, match="unknown corrupt kind"):
        ChaosConfig(corrupt=0.5, corrupt_kinds=("melt",))
    # the corruption die picks the reference's kinds in the reference's order
    cfg = dict(corrupt=0.7, seed=5)
    t, j = ChaosMonkey(ChaosConfig(**cfg), "w0"), JChaosMonkey(JChaosConfig(**cfg), "w0")
    tk = [t.on_payload({"w": torch.ones(2)}, i)[1] for i in range(12)]
    jk = [j.on_payload({"w": jnp.ones(2)}, i)[1] for i in range(12)]
    assert tk == jk and any(k is not None for k in tk)


# ---------------------------------------------------------------------------
# the seam and the socket runtime (the quadratic model)
# ---------------------------------------------------------------------------

TAU = 3


def _quad(params, batch):
    loss = torch.mean(torch.square(batch["x"] @ params["w"] + params["b"][0] - batch["y"]))
    return loss, {"loss": loss}


def _params():
    rng = np.random.default_rng(0)
    return tree_map(lambda x: torch.from_numpy(x), {
        "w": rng.standard_normal((4, 4)).astype(np.float32),
        "b": [(rng.standard_normal(4) * 0.1).astype(np.float32)]})


def _batches(cid):
    rng = np.random.default_rng(100 + cid)
    return {k: torch.from_numpy(rng.standard_normal((TAU, 1, 8, 4)).astype(np.float32))
            for k in ("x", "y")}


def _cfgs(partial=False, max_staleness=0):
    sgd = T.InnerOptConfig(name="sgd", lr_max=0.05, weight_decay=0.0, grad_clip=1e9,
                           warmup_steps=0, total_steps=10_000, alpha=1.0)
    fed = T.FederatedConfig(clients_per_round=2, local_steps=TAU, inner=sgd,
                            outer=T.OuterOptConfig(name="fedadam", lr=0.3))
    acfg = T.AsyncAggConfig(buffer_size=2, staleness_alpha=0.5, max_staleness=max_staleness)
    pcfg = T.ParticipationConfig(population=6, clients_per_round=2, dropout_rate=0.1,
                                 straggler=T.STRAGGLER_PROFILES["heavy"],
                                 partial_progress=partial, local_steps=TAU if partial else 0)
    return fed, acfg, pcfg


def _codec(name):
    return None if name == "float32" else get_codec(name, 0.25, fused=True)


def _kw(codec, **extra):
    return dict(seed=3, params=_params(), rng=T.prng_key(0), codec=codec, fused_server=True,
                **extra)


def _reference(uplink, partial=False, max_staleness=0, n=5):
    fed, acfg, pcfg = _cfgs(partial, max_staleness)
    drv = T.AsyncFederationDriver(_quad, fed, acfg, pcfg, _batches, **_kw(_codec(uplink)))
    return drv, drv.run_updates(n)


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "update"} for r in rows]


def _assert_same_run(ref, drv, h_ref, h_drv):
    assert h_ref == h_drv
    t_ref, m_ref = ref.checkpoint()
    t_drv, m_drv = drv.checkpoint()
    assert m_ref == m_drv
    a, b = params_to_numpy(t_ref), params_to_numpy(t_drv)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("uplink,partial,max_staleness", [
    ("float32", False, 0), ("topk", False, 0), ("topk", True, 2), ("int8", False, 0),
    ("float32", False, 1)], ids=["plain", "topk", "topk-partial-stale", "int8", "stale"])
def test_local_backend_is_bitwise_the_async_driver(uplink, partial, max_staleness):
    ref, h_ref = _reference(uplink, partial, max_staleness)
    fed, acfg, pcfg = _cfgs(partial, max_staleness)
    codec = _codec(uplink)
    backend = LocalClientBackend(_quad, fed, pcfg, _batches, codec=codec)
    drv = FederationDriver(backend, fed, acfg, pcfg, **_kw(codec))
    _assert_same_run(ref, drv, h_ref, drv.run_updates(5))
    assert backend.n_client_phases >= ref.n_client_phases > 0
    assert (drv.n_flushes, drv.n_admissions) == (ref.n_flushes, ref.n_admissions)


def _start_workers(fed, pcfg, port, codec, n=2, **kw):
    # a worker that finds the server gone gives up within seconds, not a minute
    workers = [ClientWorker(_quad, fed, pcfg, make_batches=_batches, port=port, codec=codec,
                            name=f"w{i}", io_timeout=5.0, backoff=Backoff(give_up_after=2.0),
                            device="cpu", **kw) for i in range(n)]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for t in threads:
        t.start()
    return workers, threads


def _stop(backend, threads):
    backend.close(linger=0.2)
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("uplink", ["float32", "topk", "int8"])
def test_socket_run_with_worker_threads_is_bitwise_in_process(uplink):
    ref, h_ref = _reference(uplink)
    fed, acfg, pcfg = _cfgs()
    codec = _codec(uplink)
    backend = SocketBackend(port=0, lease_timeout=10.0, io_timeout=5.0, device="cpu")
    workers, threads = _start_workers(fed, pcfg, backend.port, codec)
    try:
        drv = FederationDriver(backend, fed, acfg, pcfg, **_kw(codec))
        _assert_same_run(ref, drv, h_ref, drv.run_updates(5))
    finally:
        _stop(backend, threads)
    # every executed assignment ran one client phase (one encode each)
    assert sum(w.n_client_phases for w in workers) >= ref.n_client_phases
    assert backend.clock.frames > 0 and all(w.clock.frames > 0 for w in workers)


def test_close_joins_every_connection_thread():
    """``SocketBackend.close`` wakes and joins the threads serving its
    connections, idle ones included: a thread left decoding a frame into
    tensors when the interpreter exits aborts the server process."""
    before = set(threading.enumerate())
    backend = SocketBackend(port=0, lease_timeout=10.0, io_timeout=5.0, device="cpu")
    clients = [socket.create_connection(("127.0.0.1", backend.port)) for _ in range(2)]

    def conn_threads():
        return [t for t in threading.enumerate()
                if t.name == "runtime-conn" and t not in before]

    try:
        t0 = time.monotonic()
        while len(conn_threads()) < 2 and time.monotonic() - t0 < 5.0:
            time.sleep(0.01)
        threads = conn_threads()
        assert len(threads) == 2
        t0 = time.monotonic()
        backend.close()
        assert not any(t.is_alive() for t in threads)
        assert time.monotonic() - t0 < 4.0  # woken, not waited out to io_timeout
    finally:
        for c in clients:
            c.close()


def test_expired_lease_is_redispatched_to_a_live_worker():
    """A worker that pulls an assignment and dies must not wedge the run: the
    slot is re-granted after the lease and the run keeps the in-process bits."""
    ref, h_ref = _reference("topk", n=3)
    fed, acfg, pcfg = _cfgs()
    codec = _codec("topk")
    backend = SocketBackend(port=0, lease_timeout=0.4, io_timeout=5.0, device="cpu")
    drv = FederationDriver(backend, fed, acfg, pcfg, **_kw(codec))
    vulture = connect("127.0.0.1", backend.port, timeout=5.0)
    send_msg(vulture, "pull", {"worker": "vulture"})
    stolen = recv_msg(vulture)
    assert stolen.type == "work"
    vulture.close()
    with backend._lock:
        assert stolen.meta["index"] in backend._leases
    _, threads = _start_workers(fed, pcfg, backend.port, codec)
    try:
        _assert_same_run(ref, drv, h_ref, drv.run_updates(3))
    finally:
        _stop(backend, threads)


def test_server_kill_and_resume_is_bitwise():
    """Two updates, a checkpoint, the whole world torn down; a new server and
    workers from the checkpoint alone finish the run bitwise."""
    ref, h_ref = _reference("topk", n=5)
    fed, acfg, pcfg = _cfgs()
    codec = _codec("topk")
    backend = SocketBackend(port=0, lease_timeout=10.0, io_timeout=5.0, device="cpu")
    _, threads = _start_workers(fed, pcfg, backend.port, codec)
    try:
        drv = FederationDriver(backend, fed, acfg, pcfg, **_kw(codec))
        h_pre = drv.run_updates(2)
        tree, manifest = drv.checkpoint()
    finally:
        _stop(backend, threads)
    del drv, backend
    codec = _codec("topk")
    backend2 = SocketBackend(port=0, lease_timeout=10.0, io_timeout=5.0, device="cpu")
    _, threads2 = _start_workers(fed, pcfg, backend2.port, codec)
    try:
        drv2 = FederationDriver(backend2, fed, acfg, pcfg, seed=3, codec=codec,
                                fused_server=True, state=tree, dispatch=manifest)
        h_post = drv2.run_updates(3)
    finally:
        _stop(backend2, threads2)
    assert _strip(h_pre) == _strip(h_ref[:2])
    assert _strip(h_post) == _strip(h_ref[2:])
    t_ref, m_ref = ref.checkpoint()
    t2, m2 = drv2.checkpoint()
    assert m_ref == m2
    for k, v in params_to_numpy(t_ref).items():
        np.testing.assert_array_equal(params_to_numpy(t2)[k], v, err_msg=k)


class _StallingBackend(LocalClientBackend):
    """Raises TimeoutError for the first ``stalls`` timed waits, then serves."""

    def __init__(self, *a, stalls=0, **kw):
        super().__init__(*a, **kw)
        self.stalls = stalls
        self.calls = 0

    def result(self, index, timeout=None):
        self.calls += 1
        if timeout is not None and self.stalls > 0:
            self.stalls -= 1
            raise TimeoutError(f"slot {index} stalled (injected)")
        return super().result(index, timeout)


def test_deadline_flush_on_an_empty_buffer_changes_nothing():
    ref, h_ref = _reference("float32", n=4)
    fed, acfg, pcfg = _cfgs()
    backend = _StallingBackend(_quad, fed, pcfg, _batches, stalls=3)
    drv = FederationDriver(backend, fed, acfg, pcfg, flush_deadline=0.01, **_kw(None))
    h = drv.run_updates(4)
    assert backend.calls > 4  # the stalls happened
    _assert_same_run(ref, drv, h_ref, h)


def test_deadline_flush_emits_a_partial_update_when_the_buffer_holds_deltas():
    fed, acfg, pcfg = _cfgs()
    backend = _StallingBackend(_quad, fed, pcfg, _batches, stalls=0)
    drv = FederationDriver(backend, fed, acfg, pcfg, flush_deadline=0.01, **_kw(None))
    drv.run_updates(1)
    while int(drv.state["buf_count"]) != 1:
        drv.step()
    round_before = int(drv.state["round"])
    backend.stalls = 1
    rows = []
    while not rows:
        rows = drv.step()
    assert rows[0]["buffer_fill"] == 1.0  # flushed half full
    assert int(drv.state["round"]) > round_before and backend.stalls == 0


def test_traced_socket_run_counts_bytes_and_passes_the_check(tmp_path):
    """Fused int8 uplink, traced: the server's payload bytes are the codec's
    bytes times the accepted pushes, the driver's byte total counts its
    processed uploads, the bits are the untraced run's, and the merged trace
    (server and both workers) passes the report's check."""
    ref, h_ref = _reference("int8")
    fed, acfg, pcfg = _cfgs()
    codec = _codec("int8")
    tracer = Tracer(JsonlSink(str(tmp_path / "server.jsonl")), proc="server", trace_id="t")
    backend = SocketBackend(port=0, lease_timeout=10.0, io_timeout=5.0, device="cpu", tracer=tracer)
    wtracers = [Tracer(JsonlSink(str(tmp_path / f"w{i}.jsonl")), proc=f"w{i}", trace_id="t")
                for i in range(2)]
    workers = [ClientWorker(_quad, fed, pcfg, make_batches=_batches, port=backend.port,
                            codec=codec, name=f"w{i}", io_timeout=5.0, tracer=wtracers[i],
                            backoff=Backoff(give_up_after=2.0), device="cpu") for i in range(2)]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for t in threads:
        t.start()
    try:
        drv = FederationDriver(backend, fed, acfg, pcfg, tracer=tracer, **_kw(codec))
        _assert_same_run(ref, drv, h_ref, drv.run_updates(5))
    finally:
        _stop(backend, threads)
    drv.finalize_trace()
    tracer.close()
    for wt in wtracers:
        wt.close()
    per_upload = codec.payload_nbytes(codec.encode(_params())[0])
    counters = tracer.snapshot()["counters"]
    accepted_pushes = counters["pushes"] - counters.get("dedup_drops", 0)
    assert backend.payload_bytes_rx == counters["payload_bytes_rx"]
    assert backend.payload_bytes_rx == per_upload * accepted_pushes
    processed = counters.get("outcome_admitted", 0) + counters.get("outcome_rejected", 0)
    assert drv.uplink_bytes_total == drv._bytes_per_upload * processed
    assert counters["bytes_tx"] > 0 and counters["bytes_rx"] > 0
    assert check_run(load_run(str(tmp_path))) == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SMALL = ["--reduced", "--rounds", "1", "--local-steps", "2", "--clients", "2",
         "--population", "4", "--seq-len", "64"]


@pytest.mark.parametrize("extra", [
    ["--runtime", "sockets"],
    ["--runtime", "sockets", "--role", "client", "--fused-server"],
    ["--runtime", "sockets", "--aggregation", "async", "--byzantine-fraction", "0.5"],
    ["--runtime", "sockets", "--aggregation", "async", "--cohort-tile", "2"],
], ids=lambda x: "_".join(a.strip("-") for a in x))
def test_cli_runtime_refusals_have_the_references_wording(extra):
    msgs = []
    for mod, dev in ((jt, []), (tt, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            mod.run(mod.parse_args(SMALL + extra + dev))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and len(msgs[0]) > 20, msgs


def test_cli_accepts_every_flag_of_the_references_parser():
    """Each of the reference parser's options parses here with the same
    default (the port adds only ``--device``)."""
    ref = vars(jt.parse_args([]))
    ours = vars(tt.parse_args([]))
    assert set(ours) - set(ref) == {"device"}
    assert {k: ours[k] for k in ref} == ref
    assert not hasattr(tt, "_UNPORTED_FLAGS")


SOCKET_CLI = ["--reduced", "--rounds", "3", "--local-steps", "2", "--clients", "4",
              "--population", "8", "--seq-len", "64", "--device", "cpu", "--fused-server",
              "--aggregation", "async", "--straggler-profile", "heavy", "--uplink", "int8",
              "--eval-batches", "1"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _spawn(args, log):
    # one torch thread, as this process runs (tests/torch_parity.py): the
    # rows are compared bitwise with an in-process run here
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train"] + args,
                            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)


def test_three_process_cli_run_is_the_in_process_run(tmp_path):
    """One ``--role server`` and two ``--role client`` subprocesses: every CSV
    field of the server's rows but the wall clock is the in-process CLI's."""
    procs = []
    try:
        with open(tmp_path / "server.out", "w") as slog:
            server = _spawn(SOCKET_CLI + ["--runtime", "sockets", "--role", "server",
                                          "--port", "0", "--log", str(tmp_path / "s.csv")],
                            slog)
            procs.append(server)
            port = None
            for _ in range(1200):  # the server prints its port once it listens
                text = (tmp_path / "server.out").read_text()
                if "server listening on" in text:
                    port = text.split("server listening on")[1].split()[0].rsplit(":", 1)[1]
                    break
                assert server.poll() is None, text
                threading.Event().wait(0.1)
            assert port is not None
            for i in range(2):
                with open(tmp_path / f"w{i}.out", "w") as wlog:
                    procs.append(_spawn(SOCKET_CLI + ["--runtime", "sockets", "--role", "client",
                                                      "--port", port, "--worker-id", f"w{i}",
                                                      "--io-timeout", "10"], wlog))
            assert server.wait(timeout=300) == 0, (tmp_path / "server.out").read_text()
        tt.run(tt.parse_args(SOCKET_CLI + ["--log", str(tmp_path / "i.csv")]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
            p.wait(timeout=30)
    got, want = _rows(tmp_path / "s.csv"), _rows(tmp_path / "i.csv")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k != "seconds":
                assert g[k] == w[k], k
    assert "worker w0 serving" in (tmp_path / "w0.out").read_text()


def test_every_leaf_of_a_params_snapshot_crosses_once(tmp_path):
    """``SocketBackend`` frames a pulled snapshot leaf by leaf: the work
    frame's array list is the params' leaves (plus the key), each written once."""
    fed, acfg, pcfg = _cfgs()
    codec = _codec("topk")
    backend = SocketBackend(port=0, lease_timeout=10.0, io_timeout=5.0, device="cpu")
    try:
        FederationDriver(backend, fed, acfg, pcfg, **_kw(codec))
        sock = connect("127.0.0.1", backend.port, timeout=5.0)
        send_msg(sock, "pull", {"worker": "probe"})
        work = recv_msg(sock)
        sock.close()
    finally:
        backend.close()
    assert work.type == "work"
    assert len(tree_leaves(work.trees["params"])) == len(tree_leaves(_params()))
    assert work.trees["rng"].shape == (2,) and work.trees["residual"]["w"].shape == (1, 4, 4)
