"""Build and load the engine's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper); the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``fantoch_tpu_torch/_build/`` (keyed
by a hash of the sources), and uses nothing but the sources in this
package and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# the loaded library and the seconds its build took (None when reused)
_LIB: "ctypes.CDLL | None" = None
BUILD_SECONDS: "float | None" = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "on the machine with the GPU"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source (one ``nvcc`` each, in parallel) and link
    them into ``libfantoch_kernels.so``; returns its path. Reuses a
    library already built from identical sources."""
    global BUILD_SECONDS
    out = BUILD_ROOT / _digest()
    lib = out / "libfantoch_kernels.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", f"-I{CSRC}"]
    procs = []
    for src in _sources():
        obj = out / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log = []
    failed = []
    for src, _obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log)
        )
    tmp = out / "libfantoch_kernels.so.tmp"
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp),
         *[str(o) for _s, o, _p in procs]],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
    tmp.rename(lib)
    BUILD_SECONDS = time.perf_counter() - t0
    if verbose:
        print("\n".join(log))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB


@functools.lru_cache(maxsize=None)
def c_function(name: str, n_ptr: int, n_int: int):
    """Bind ``int name(void* x n_ptr, int x n_int, void* stream)``: every
    pointer and the stream as ``c_void_p`` (a plain int would cut them
    to 32 bits), the return value the launch's ``cudaGetLastError()``.
    Bound once per entry point."""
    fn = getattr(library(), name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def launch(fn, ptrs, ints, stream) -> None:
    """Call a bound kernel entry point; raise if the launch failed."""
    rc = fn(*ptrs, *ints, stream)
    if rc != 0:
        raise RuntimeError(
            f"{fn.__name__} launch failed: cudaError {rc}"
        )


def check(name: str, t, dtype, shape, device) -> None:
    """Validate one kernel argument: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


# the monitor planes a monitored step carries inside ``ps``
# (engine/monitor.py MON_PS_KEYS)
MON_PS_KEYS = ("_mon_hash", "_mon_cnt", "_mon_flags")


def mon_planes(ps, L: int, N: int, device):
    """A handler kernel's monitor arguments (``csrc/monitor.cuh``):
    ``(pointers, KM, new)`` — the hash, count and guard planes in, then
    out; the key capacity; the new planes for the kernel's ``ps``. When
    ``ps`` carries no monitor planes: six null pointers, 0 and ``{}``."""
    import torch

    if MON_PS_KEYS[0] not in ps:
        return [0] * 6, 0, {}
    KM = ps["_mon_hash"].shape[2]
    check("ps/_mon_hash", ps["_mon_hash"], torch.int32, (L, N, KM), device)
    check("ps/_mon_cnt", ps["_mon_cnt"], torch.int32, (L, N, KM), device)
    check("ps/_mon_flags", ps["_mon_flags"], torch.int32, (L, N), device)
    new = {k: torch.empty_like(ps[k]) for k in MON_PS_KEYS}
    ptrs = ([ps[k].data_ptr() for k in MON_PS_KEYS]
            + [new[k].data_ptr() for k in MON_PS_KEYS])
    return ptrs, KM, new
