"""Protocol layer of the host oracle: the abstraction and the protocols
whose oracle is ported (reference: ``fantoch/src/protocol/`` and
``fantoch_ps/src/protocol/``). Tempo, Atlas, EPaxos and Caesar are still
to port (ROADMAP Queue A item 17): :data:`BY_NAME` holds only what is
here."""

from .base import (
    Action,
    BaseProcess,
    CommandsInfo,
    GCTrack,
    Message,
    Protocol,
    ProtocolMetrics,
    ProtocolMetricsKind,
    ToForward,
    ToSend,
)
from .basic import Basic
from .fpaxos import FPaxos

# protocol name -> host (oracle) class; the CLI and the schedule fuzzer
# resolve through here
BY_NAME = {
    "basic": Basic,
    "fpaxos": FPaxos,
}

__all__ = [
    "Action", "BY_NAME", "BaseProcess", "Basic", "CommandsInfo", "FPaxos",
    "GCTrack", "Message", "Protocol", "ProtocolMetrics",
    "ProtocolMetricsKind", "ToForward", "ToSend",
]
