"""Array-state protocol implementations for the device engine.

Each module is the fixed-shape twin of a protocol of the reference's
device engine, batched over an explicit ``[L, N]`` (lane, process) axis.
This slice ports Basic; the other protocols raise by name.
"""

from .basic import BasicDev

__all__ = ["BasicDev", "dev_protocol"]

# protocol → the ROADMAP Queue A item that ports it
_NOT_PORTED = {
    "fpaxos": "3",
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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"protocol {name!r} is not ported yet (ROADMAP Queue A item "
            f"{_NOT_PORTED[name]})"
        )
    raise ValueError(f"unknown protocol {name!r}")
