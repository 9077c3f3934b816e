"""Length-prefixed socket transport of the cross-process runtime: frames of
torch tensor trees whose bytes are ``repro.runtime.transport``'s.

Wire format (one message per frame):

    [8-byte big-endian payload length][4-byte big-endian CRC-32 of the payload]
    [4-byte big-endian header length][header JSON (utf-8)][array blobs ...]

The header is ``{"type": ..., "meta": {...}, "arrays": [...]}``: ``meta`` is
plain JSON and ``arrays`` lists ``{"key", "dtype", "shape", "nbytes"}`` for
the raw little-endian blobs concatenated after the header, in order. Dtype
names are numpy's (``"float32"``, ``"int8"``, ``"uint32"``, ...); bfloat16
blobs are the raw 2-byte words under the name ``"bfloat16"`` (the name
``ml_dtypes`` gives them), so no bfloat16 numpy type is needed on either side.

Trees cross the wire as nested containers: string-keyed dicts plus lists and
tuples. Each leaf's key is ``field + SEP + k1 + SEP + k2 + ...`` (``SEP`` is
the ASCII unit separator); a list or tuple element's segment is its index
behind ``LIST_MARK`` / ``TUPLE_MARK``, so the receiver rebuilds the exact
container types. Empty containers carry no arrays and do not survive, and a
0-dim leaf arrives with shape ``(1,)`` (the reference's encoder widens it so):
the int8 codecs read a scale of either shape.

Tensors leave the card through one host copy per leaf, straight into the
frame buffer (``encode_msg``), and arrive on the receiver's ``device`` through
one copy per leaf (``decode_msg``). Leaves of a dtype torch does not compute
with (``uint32``: the package's PRNG keys, ``core.federated.prng_key``) stay
numpy arrays on the host. A CUDA leaf is read on the calling thread's current
stream, after the work that produced it.

``send_msg`` / ``recv_msg`` are synchronous over a connected socket;
``recv_exact`` loops until the frame is complete, and EOF, a bad length or a
CRC mismatch raises ``TransportError`` so callers fold it into their
retry/backoff path.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "\x1f"  # unit separator: joins tree-path segments in array keys
LIST_MARK = "\x1e"  # path segment prefix: this node is a list element
TUPLE_MARK = "\x1d"  # path segment prefix: this node is a tuple element
_RESERVED = (SEP, LIST_MARK, TUPLE_MARK)
_LEN = struct.Struct("!Q")
_CRC = struct.Struct("!I")  # CRC-32 of the payload, between length and body
_HDR = struct.Struct("!I")
MAX_FRAME = 1 << 33  # 8 GiB sanity bound — a corrupt length must not OOM us
FRAME_OVERHEAD = _LEN.size + _CRC.size  # per-frame bytes beyond the payload

#: torch dtypes by their numpy name; other names decode to numpy arrays
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


class TransportError(ConnectionError):
    """Framing/EOF/decoding failure — retryable by reconnecting."""


class FrameCorruptError(TransportError):
    """Payload CRC mismatch — the bytes on the wire are not the bytes sent.
    A :class:`TransportError`, so every retry path absorbs it by
    reconnecting; the type tells corruption apart from a plain EOF."""


class FrameClock:
    """Host seconds one endpoint spends framing: building a frame (the device
    to host copies into it) and its CRC on send, the CRC and the copies out
    on receive. Thread-safe: the server's connection threads share one."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds = 0.0
        self.frames = 0

    def add(self, seconds: float) -> None:
        with self._lock:
            self.seconds += seconds
            self.frames += 1


def flatten_tree(tree: Any, prefix: str) -> List[Tuple[str, Any]]:
    """Nested dict/list/tuple containers → sorted ``(path, leaf)`` list. The
    container types are encoded in the path segments themselves."""
    out: List[Tuple[str, Any]] = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            if any(c in str(k) for c in _RESERVED):
                raise ValueError(f"tree key {k!r} contains a reserved wire byte")
            out.extend(flatten_tree(tree[k], prefix + SEP + str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        mark = LIST_MARK if isinstance(tree, list) else TUPLE_MARK
        for i, v in enumerate(tree):
            out.extend(flatten_tree(v, prefix + SEP + mark + str(i)))
        return out
    return [(prefix, tree)]


def _materialize(node: Any) -> Any:
    """Convert marker-keyed dict nodes back into the list/tuple they encode."""
    if not isinstance(node, dict):
        return node
    keys = list(node)
    for mark, ctor in ((LIST_MARK, list), (TUPLE_MARK, tuple)):
        if keys and all(k[:1] == mark for k in keys):
            order = sorted(keys, key=lambda s: int(s[1:]))
            return ctor(_materialize(node[k]) for k in order)
    return {k: _materialize(v) for k, v in node.items()}


def unflatten_tree(items: Dict[str, Any]) -> Any:
    """Inverse of :func:`flatten_tree` for one field's ``path → leaf`` map.
    Paths are relative to the field (empty path == the field IS one leaf)."""
    if list(items) == [""]:
        return items[""]
    root: Dict[str, Any] = {}
    for path, leaf in items.items():
        parts = path.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return _materialize(root)


@dataclass
class Message:
    type: str
    meta: Dict[str, Any] = field(default_factory=dict)
    trees: Dict[str, Any] = field(default_factory=dict)  # field → tree of tensors


def _as_leaf(x):
    """A tensor (detached) or a C-contiguous numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return np.ascontiguousarray(np.asarray(x))


def _describe(x) -> Tuple[str, List[int], int]:
    if isinstance(x, torch.Tensor):
        if x.dtype not in _DTYPE_NAMES:
            raise ValueError(f"tensor dtype {x.dtype} has no wire name")
        # a 0-dim leaf goes out as shape [1], as numpy's ascontiguousarray
        # makes it in the reference's encoder (bytes identical)
        return _DTYPE_NAMES[x.dtype], list(x.shape) or [1], x.numel() * x.element_size()
    return x.dtype.name, list(x.shape), int(x.nbytes)


def _write_leaf(out: bytearray, offset: int, x, nbytes: int) -> None:
    """Copy one leaf's bytes into ``out[offset:offset + nbytes]``: a CUDA
    tensor goes device → frame in one copy."""
    if nbytes == 0:
        return
    if isinstance(x, torch.Tensor):
        src = x.contiguous().reshape(-1).view(torch.uint8)
        torch.frombuffer(out, dtype=torch.uint8, count=nbytes, offset=offset).copy_(src)
    else:
        dst = np.frombuffer(out, dtype=np.uint8, count=nbytes, offset=offset)
        dst[...] = x.reshape(-1).view(np.uint8)


def encode_msg(
    mtype: str,
    meta: Optional[Dict[str, Any]] = None,
    trees: Optional[Dict[str, Any]] = None,
) -> bytearray:
    """One frame payload (without the length and CRC prefix)."""
    arrays: List[Dict[str, Any]] = []
    leaves = []
    for fname, tree in (trees or {}).items():
        if tree is None:
            continue
        if SEP in fname:
            raise ValueError(f"tree field {fname!r} contains the wire separator")
        for path, x in flatten_tree(tree, fname):
            x = _as_leaf(x)
            name, shape, nbytes = _describe(x)
            arrays.append({"key": path, "dtype": name, "shape": shape, "nbytes": nbytes})
            leaves.append(x)
    header = json.dumps(
        {"type": mtype, "meta": meta or {}, "arrays": arrays}
    ).encode("utf-8")
    offset = _HDR.size + len(header)
    out = bytearray(offset + sum(a["nbytes"] for a in arrays))
    _HDR.pack_into(out, 0, len(header))
    out[_HDR.size:offset] = header
    for x, a in zip(leaves, arrays):
        _write_leaf(out, offset, x, a["nbytes"])
        offset += a["nbytes"]
    return out


def _read_leaf(payload, offset: int, entry: Dict[str, Any], device):
    n, name, shape = int(entry["nbytes"]), entry["dtype"], list(entry["shape"])
    dtype = _TORCH_DTYPES.get(name)
    if dtype is None:  # numpy-only dtypes (the PRNG keys' uint32) stay on the host
        return np.frombuffer(payload, dtype=np.dtype(name), count=n // np.dtype(name).itemsize,
                             offset=offset).reshape(shape).copy()
    if n == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    raw = torch.frombuffer(payload, dtype=torch.uint8, count=n, offset=offset)
    # one copy into fresh (aligned) memory on the receiver's device
    raw = raw.to(device) if torch.device(device).type != "cpu" else raw.clone()
    return raw.view(dtype).reshape(shape)


def decode_msg(payload, device="cpu") -> Message:
    """Inverse of :func:`encode_msg`; tensor leaves land on ``device``."""
    if isinstance(payload, bytes):
        payload = bytearray(payload)  # torch reads only writable buffers
    if len(payload) < _HDR.size:
        raise TransportError("frame shorter than its header-length field")
    (hlen,) = _HDR.unpack_from(payload, 0)
    try:
        header = json.loads(bytes(payload[_HDR.size:_HDR.size + hlen]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise TransportError(f"bad message header: {e}") from e
    offset = _HDR.size + hlen
    fields: Dict[str, Dict[str, Any]] = {}
    for entry in header.get("arrays", ()):
        n = int(entry["nbytes"])
        if offset + n > len(payload):
            raise TransportError("frame truncated inside an array blob")
        leaf = _read_leaf(payload, offset, entry, device)
        offset += n
        fname, _, rel = entry["key"].partition(SEP)
        fields.setdefault(fname, {})[rel] = leaf
    trees = {fname: unflatten_tree(items) for fname, items in fields.items()}
    return Message(header["type"], header.get("meta", {}), trees)


# ---------------------------------------------------------------------------
# Socket framing
# ---------------------------------------------------------------------------


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            raise TransportError("connection closed mid-frame")
        got += k
    return buf


def send_frame(sock: socket.socket, payload, crc: Optional[int] = None) -> None:
    if crc is None:
        crc = zlib.crc32(payload)
    sock.sendall(_LEN.pack(len(payload)) + _CRC.pack(crc))
    sock.sendall(payload)


def recv_frame(sock: socket.socket, clock: Optional[FrameClock] = None) -> bytearray:
    (n,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise TransportError(f"frame length {n} exceeds MAX_FRAME")
    (crc,) = _CRC.unpack(recv_exact(sock, _CRC.size))
    payload = recv_exact(sock, n)
    t0 = time.perf_counter()
    ok = zlib.crc32(payload) == crc
    if clock is not None:
        clock.add(time.perf_counter() - t0)
    if not ok:
        raise FrameCorruptError(
            f"frame CRC mismatch ({len(payload)} bytes): payload corrupted in flight"
        )
    return payload


def send_msg(
    sock: socket.socket,
    mtype: str,
    meta: Optional[Dict[str, Any]] = None,
    trees: Optional[Dict[str, Any]] = None,
    chaos=None,
    tracer=None,
    clock: Optional[FrameClock] = None,
) -> bool:
    """Send one message; returns False when chaos injection dropped it (the
    peer sees nothing and must recover via its own timeout). A chaos *kill*
    never returns at all.

    ``tracer`` counts wire truth — frame bytes handed to the socket (payload,
    length prefix and CRC) — only for messages that really go out: the chaos
    roll happens first. ``clock`` adds the host seconds of building the frame
    and its CRC."""
    if chaos is not None and chaos.on_send():
        return False
    t0 = time.perf_counter()
    payload = encode_msg(mtype, meta, trees)
    crc = zlib.crc32(payload)
    if clock is not None:
        clock.add(time.perf_counter() - t0)
    send_frame(sock, payload, crc)
    if tracer is not None and tracer.enabled:
        tracer.count("bytes_tx", len(payload) + FRAME_OVERHEAD)
        tracer.count("msgs_tx")
    return True


def recv_msg(sock: socket.socket, tracer=None, device="cpu",
             clock: Optional[FrameClock] = None) -> Message:
    """Receive one message; its tensors land on ``device``. ``clock`` adds
    the host seconds of the CRC and of copying the leaves out."""
    payload = recv_frame(sock, clock)
    if tracer is not None and tracer.enabled:
        tracer.count("bytes_rx", len(payload) + FRAME_OVERHEAD)
        tracer.count("msgs_rx")
    t0 = time.perf_counter()
    msg = decode_msg(payload, device)
    if clock is not None:
        clock.add(time.perf_counter() - t0)
    return msg


# ---------------------------------------------------------------------------
# Bounded exponential backoff (client pull/push retry discipline)
# ---------------------------------------------------------------------------


@dataclass
class Backoff:
    """Deterministic bounded exponential backoff: base · 2^attempt, capped.

    ``give_up_after`` bounds the TOTAL time since the last success — a worker
    that cannot reach the server for that long exits instead of spinning
    forever (the supervisor decides whether to respawn it)."""

    base: float = 0.05
    cap: float = 2.0
    give_up_after: float = 60.0

    def __post_init__(self):
        self._attempt = 0
        self._since = time.monotonic()

    def reset(self) -> None:
        self._attempt = 0
        self._since = time.monotonic()

    def sleep(self) -> bool:
        """Back off once; returns False when the give-up budget is exhausted."""
        if time.monotonic() - self._since > self.give_up_after:
            return False
        time.sleep(min(self.cap, self.base * (2.0 ** self._attempt)))
        self._attempt += 1
        return True


def connect(host: str, port: int, timeout: float) -> socket.socket:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
