"""Array-state protocol implementations for the device engine.

Each module is the fixed-shape twin of a protocol of the reference's
device engine, batched over an explicit ``[L, N]`` (lane, process) axis.
Basic, FPaxos, Tempo, Atlas, EPaxos and Caesar are ported, and Tempo's
partial-replication twin.
"""

from .basic import BasicDev
from .caesar import CaesarDev
from .fpaxos import FPaxosDev
from .graphdep import AtlasDev, EPaxosDev
from .tempo import TempoDev
from .tempo_partial import TempoPartialDev

__all__ = ["AtlasDev", "BasicDev", "CaesarDev", "EPaxosDev", "FPaxosDev",
           "TempoDev", "TempoPartialDev", "dev_config_kwargs",
           "dev_protocol", "partial_dev_protocol"]


def dev_protocol(name: str, clients: int = 0, keys: "int | None" = None):
    """The protocol-name → device-protocol switch. The key tables
    follow the load: ``keys`` (default one per client plus the shared
    conflict key), and Tempo's and Caesar's capacities also
    ``clients``, as the reference's ``dev_protocol``."""
    keys = keys if keys is not None else 1 + clients
    if name == "tempo":
        return TempoDev.for_load(keys=keys, clients=clients)
    if name == "atlas":
        return AtlasDev(keys=keys)
    if name == "epaxos":
        return EPaxosDev(keys=keys)
    if name == "basic":
        return BasicDev
    if name == "fpaxos":
        return FPaxosDev
    if name == "caesar":
        return CaesarDev.for_load(keys=keys, clients=clients)
    raise ValueError(f"unknown protocol {name!r}")


def partial_dev_protocol(name: str, clients: int, shards: int,
                         keys_per_cmd: int = 2, pool_size: int = 1):
    """The partial-replication twin switch, as the reference's: only
    the protocols whose reference implements partial.rs have one. The
    key table holds the conflict pool, one private key per client and
    a spare."""
    keys = pool_size + clients + 1
    if name == "tempo":
        return TempoPartialDev(keys=keys, shards=shards,
                               keys_per_cmd=keys_per_cmd)
    if name == "atlas":
        raise NotImplementedError(
            "Atlas's partial-replication twin is not ported yet (ROADMAP "
            "Queue A item 8)"
        )
    raise ValueError(
        f"{name} does not support partial replication (only tempo and "
        "atlas implement the reference's partial.rs paths)"
    )


def dev_config_kwargs(name: str, n: int, f: int, **overrides):
    """Default Config kwargs per protocol, as the reference's
    ``dev_config_kwargs`` for the ported ones (FPaxos's initial leader
    is process 1; Tempo sends detached votes every 100 ms; Caesar runs
    with the wait condition);
    ``overrides`` win."""
    kw = dict(n=n, f=f, gc_interval_ms=100)
    if name == "tempo":
        kw["tempo_detached_send_interval_ms"] = 100
    if name == "fpaxos":
        kw["leader"] = 1
    if name == "caesar":
        kw["caesar_wait_condition"] = True
    kw.update(overrides)
    return kw
