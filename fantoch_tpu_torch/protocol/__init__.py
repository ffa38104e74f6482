"""Protocol layer of the host oracle: the abstraction and the oracle
protocols (reference: ``fantoch/src/protocol/`` and
``fantoch_ps/src/protocol/``). :data:`BY_NAME` holds the reference's
seven names; Tempo and Atlas also run partial replication through
``partial.py``."""

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
from .atlas import Atlas
from .basic import Basic
from .caesar import Caesar
from .epaxos import EPaxos
from .fpaxos import FPaxos
from .tempo import Tempo, TempoAtomic

# protocol name -> host (oracle) class; the CLI and the schedule fuzzer
# resolve through here
BY_NAME = {
    "basic": Basic,
    "fpaxos": FPaxos,
    "tempo": Tempo,
    "tempo_atomic": TempoAtomic,
    "atlas": Atlas,
    "epaxos": EPaxos,
    "caesar": Caesar,
}

__all__ = [
    "Action", "Atlas", "BY_NAME", "BaseProcess", "Basic", "Caesar",
    "CommandsInfo", "EPaxos", "FPaxos", "GCTrack", "Message", "Protocol",
    "ProtocolMetrics", "ProtocolMetricsKind", "Tempo", "TempoAtomic",
    "ToForward", "ToSend",
]
