"""ctypes binding for the native atomic key-clock sequencer
(keyclocks.cpp — the ``AtomicKeyClocks`` + ``SharedMap`` analog,
atomic.rs:13-90, shared.rs:18-112).

Keys are integers here (the sequencer benchmark's universe); the Python
`SequentialKeyClocks` (protocol/table.py) remains the canonical
string-keyed variant used by the oracle protocols.

The library is built at first use with ``g++ -O2 -std=c++17 -shared
-fPIC -pthread`` into ``fantoch_tpu_torch/_build/native/`` (keyed by a
hash of the source); nothing is written beside the source. A failed
build raises with the compiler's message, every time it is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

SRC = Path(__file__).resolve().parent / "keyclocks.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
COMPILE = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

u64 = ctypes.c_uint64
u64p = ctypes.POINTER(ctypes.c_uint64)


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"keyclocks_{tag}.so"


def _build(so: Path) -> None:
    """Compile the source into ``so`` (atomic rename); raises
    ``RuntimeError`` with the compiler's output on failure."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            [*COMPILE, str(SRC), "-o", str(tmp)],
            capture_output=True, text=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native key clocks: build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native key clocks: g++ exited {proc.returncode}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)


def _load() -> ctypes.CDLL:
    """Compile (once per source hash) and load the shared library; a
    failed build raises, and raises again on every later call."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise RuntimeError(_build_error)
    so = library_path()
    if not so.exists():
        try:
            _build(so)
        except RuntimeError as e:
            _build_error = str(e)
            raise
    lib = ctypes.CDLL(str(so))
    lib.kc_new.restype = ctypes.c_void_p
    lib.kc_new.argtypes = [u64]
    lib.kc_free.argtypes = [ctypes.c_void_p]
    lib.kc_clock.restype = u64
    lib.kc_clock.argtypes = [ctypes.c_void_p, u64]
    lib.kc_proposal.restype = u64
    lib.kc_proposal.argtypes = [
        ctypes.c_void_p, u64p, u64, u64, u64p, u64, u64p,
    ]
    lib.kc_detached.restype = u64
    lib.kc_detached.argtypes = [
        ctypes.c_void_p, u64p, u64, u64, u64p, u64, u64p,
    ]
    lib.kc_stress.restype = ctypes.c_int32
    lib.kc_stress.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, u64, u64, ctypes.c_uint32,
        u64, u64p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


class AtomicKeyClocks:
    """Integer-keyed atomic key clocks; safe to share across Python
    threads (the GIL is released during native calls)."""

    def __init__(self, capacity: int):
        self._lib = _load()
        self._h = self._lib.kc_new(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.kc_free(self._h)
            self._h = None

    def clock(self, key: int) -> int:
        return self._lib.kc_clock(self._h, key)

    def proposal(
        self, keys: List[int], min_clock: int = 0
    ) -> Tuple[int, List[Tuple[int, int, int]]]:
        """Two-round bump; returns (clock, [(key, start, end) votes])."""
        nk = len(keys)
        arr = (u64 * nk)(*keys)
        cap = 3 * 2 * nk
        out = (u64 * cap)()
        out_n = u64(0)
        clock = self._lib.kc_proposal(
            self._h, arr, nk, min_clock, out, cap, ctypes.byref(out_n)
        )
        if clock == 0:
            raise RuntimeError("key table full or vote buffer overflow")
        n = out_n.value
        return clock, [
            (out[3 * i], out[3 * i + 1], out[3 * i + 2]) for i in range(n)
        ]

    def detached(
        self, keys: List[int], up_to: int
    ) -> List[Tuple[int, int, int]]:
        nk = len(keys)
        arr = (u64 * nk)(*keys)
        cap = 3 * nk
        out = (u64 * cap)()
        out_n = u64(0)
        ok = self._lib.kc_detached(
            self._h, arr, nk, up_to, out, cap, ctypes.byref(out_n)
        )
        if not ok:
            raise RuntimeError("key table full or vote buffer overflow")
        return [
            (out[3 * i], out[3 * i + 1], out[3 * i + 2])
            for i in range(out_n.value)
        ]

    def stress(
        self,
        threads: int,
        ops_per_thread: int,
        key_count: int,
        keys_per_op: int = 2,
        seed: int = 0,
    ) -> Tuple[bool, float]:
        """Hammer + verify (the reference's multi-thread test); returns
        (invariants_held, elapsed_seconds)."""
        if keys_per_op == 0 or keys_per_op > key_count:
            raise ValueError(
                f"keys_per_op={keys_per_op} must be in "
                f"[1, key_count={key_count}]"
            )
        ns = u64(0)
        ok = self._lib.kc_stress(
            self._h,
            threads,
            ops_per_thread,
            key_count,
            keys_per_op,
            seed,
            ctypes.byref(ns),
        )
        return bool(ok), ns.value / 1e9

