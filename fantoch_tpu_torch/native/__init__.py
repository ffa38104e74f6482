"""Native (C++) helpers of the host oracle, bound through ctypes.

The reference implements its intra-process concurrency primitives in
native code (Rust: the lock-free ``AtomicKeyClocks`` sequencer and the
sharded ``SharedMap``); the analog here is C++ (``keyclocks.cpp``),
compiled at first use with ``g++`` into ``fantoch_tpu_torch/_build/``.
It is host code: ``TempoAtomic``'s key clocks, no device kernel.
"""

from .keyclocks import AtomicKeyClocks, available

__all__ = ["AtomicKeyClocks", "available"]
