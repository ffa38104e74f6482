"""Client/workload layer (reference: ``fantoch/src/client/``): the key
distributions lane construction needs and the host oracle's closed-loop
client and workload."""

from .client import Client, ClientData, Pending
from .key_gen import (
    CONFLICT_COLOR, ConflictPool, DeviceStream, KeyGen, KeyGenState, Zipf,
    zipf_weights,
)
from .workload import Workload

__all__ = [
    "CONFLICT_COLOR", "Client", "ClientData", "ConflictPool",
    "DeviceStream", "KeyGen", "KeyGenState", "Pending", "Workload", "Zipf",
    "zipf_weights",
]
