"""Hand-written CUDA kernels of the engine step, with their plain twins.

Each wrapper launches its kernel (``csrc/*.cu``, built for ``sm_90a`` on
first use) for CUDA tensors and runs its plain PyTorch twin for CPU
tensors; it never falls back from one to the other. Each wrapper counts
its kernel launches in a ``launches`` attribute.
"""

from __future__ import annotations

from .basic_handle import basic_handle
from .caesar_handle import caesar_handle
from .emit_rewrite import emit_rewrite
from .fpaxos_handle import fpaxos_handle
from .graphdep_handle import graphdep_handle
from .key_table import key_table
from .land_emissions import land_emissions
from .lane_freeze import lane_freeze
from .qualify_pop import qualify_pop
from .tempo_handle import tempo_handle
from .tempo_partial_handle import tempo_partial_handle

WRAPPERS = {
    "qualify_pop": qualify_pop,
    "land_emissions": land_emissions,
    "key_table": key_table,
    "basic_handle": basic_handle,
    "fpaxos_handle": fpaxos_handle,
    "emit_rewrite": emit_rewrite,
    "lane_freeze": lane_freeze,
    "tempo_handle": tempo_handle,
    "graphdep_handle": graphdep_handle,
    "caesar_handle": caesar_handle,
    "tempo_partial_handle": tempo_partial_handle,
}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
