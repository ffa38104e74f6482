"""Array-state protocol implementations for the device engine.

Each module is the fixed-shape twin of a protocol of the reference's
device engine, batched over an explicit ``[L, N]`` (lane, process) axis.
Basic and FPaxos are ported; the other protocols raise by name.
"""

from .basic import BasicDev
from .fpaxos import FPaxosDev

__all__ = ["BasicDev", "FPaxosDev", "dev_config_kwargs", "dev_protocol"]

# protocol → the ROADMAP Queue A item that ports it
_NOT_PORTED = {
    "tempo": "4",
    "atlas": "6",
    "epaxos": "6",
    "caesar": "7",
}


def dev_protocol(name: str, clients: int = 0, keys: "int | None" = None):
    """The protocol-name → device-protocol switch."""
    del clients, keys  # capacity knobs of protocols not yet ported
    if name == "basic":
        return BasicDev
    if name == "fpaxos":
        return FPaxosDev
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"protocol {name!r} is not ported yet (ROADMAP Queue A item "
            f"{_NOT_PORTED[name]})"
        )
    raise ValueError(f"unknown protocol {name!r}")


def dev_config_kwargs(name: str, n: int, f: int, **overrides):
    """Default Config kwargs per protocol, as the reference's
    ``dev_config_kwargs`` for the ported ones (FPaxos's initial leader
    is process 1); ``overrides`` win."""
    kw = dict(n=n, f=f, gc_interval_ms=100)
    if name == "fpaxos":
        kw["leader"] = 1
    kw.update(overrides)
    return kw
