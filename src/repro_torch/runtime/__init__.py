"""Cross-process federation runtime (``repro.runtime``'s counterpart).

``runtime.driver`` holds the backend-pluggable :class:`FederationDriver` (the
in-process timeline is one backend, the socket runtime another),
``runtime.server`` / ``runtime.worker`` the server and client processes,
``runtime.transport`` the length-prefixed wire format (the reference's bytes)
and the retry/backoff primitives, ``runtime.chaos`` the fault injection.
"""
from repro_torch.runtime.chaos import KILL_EXIT_CODE, ChaosConfig, ChaosMonkey
from repro_torch.runtime.driver import (
    Assignment,
    ClientBackend,
    ClientResult,
    FederationDriver,
    LocalClientBackend,
    build_client_phase,
)
from repro_torch.runtime.server import SocketBackend
from repro_torch.runtime.transport import (
    Backoff,
    FrameClock,
    Message,
    TransportError,
    connect,
    decode_msg,
    encode_msg,
    recv_msg,
    send_msg,
)
from repro_torch.runtime.worker import ClientWorker

__all__ = [
    "Assignment",
    "Backoff",
    "ChaosConfig",
    "ChaosMonkey",
    "ClientBackend",
    "ClientResult",
    "ClientWorker",
    "FederationDriver",
    "FrameClock",
    "KILL_EXIT_CODE",
    "LocalClientBackend",
    "Message",
    "SocketBackend",
    "TransportError",
    "build_client_phase",
    "connect",
    "decode_msg",
    "encode_msg",
    "recv_msg",
    "send_msg",
]
