"""Hand-written CUDA kernels of the engine step, with their plain twins.

Each wrapper launches its kernel (``csrc/*.cu``, built for ``sm_90a`` on
first use) for CUDA tensors and runs its plain PyTorch twin for CPU
tensors; it never falls back from one to the other. Each wrapper counts
its kernel launches in a ``launches`` attribute. A device loop's graph
(``step_loop``, launched by ``launch_window``) replays kernels without their wrappers: :func:`counts`
adds those launches from the loop's body counter on the device.
"""

from __future__ import annotations

from .atlas_partial_handle import atlas_partial_handle
from .basic_handle import basic_handle
from .caesar_handle import caesar_handle
from .emit_rewrite import emit_rewrite
from .fpaxos_handle import fpaxos_handle
from .graphdep_handle import graphdep_handle
from .key_table import key_table
from .land_emissions import land_emissions
from .loop_ctl import loop_ctl
from .mon_finalize import mon_finalize
from .qualify_pop import qualify_pop
from .step_loop import (
    launch_window, replayed_counts, reset_replayed_counts,
)
from .tempo_handle import tempo_handle
from .tempo_partial_handle import tempo_partial_handle

WRAPPERS = {
    "qualify_pop": qualify_pop,
    "land_emissions": land_emissions,
    "key_table": key_table,
    "basic_handle": basic_handle,
    "fpaxos_handle": fpaxos_handle,
    "emit_rewrite": emit_rewrite,
    "tempo_handle": tempo_handle,
    "graphdep_handle": graphdep_handle,
    "caesar_handle": caesar_handle,
    "tempo_partial_handle": tempo_partial_handle,
    "atlas_partial_handle": atlas_partial_handle,
    "mon_finalize": mon_finalize,
    "loop_ctl": loop_ctl,
    "step_loop": launch_window,
}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    reset_replayed_counts()


def counts() -> dict:
    """Launches by kernel since the last reset: each wrapper's own and
    those of replayed device-loop graphs (reads the device)."""
    replayed = replayed_counts()
    return {name: fn.launches + replayed.get(name, 0)
            for name, fn in WRAPPERS.items()}
