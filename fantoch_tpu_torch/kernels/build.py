"""Build and load the engine's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper); the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``fantoch_tpu_torch/_build/`` (keyed
by a hash of the sources), and uses nothing but the sources in this
package and the CUDA toolkit. Processes may build at once (``fleet
--workers``): each compiles and links in a directory of its own under the
digest and moves the finished library into place with one atomic
``os.replace``, so no process links or loads a file another is writing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
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
    library already built from identical sources. The objects, the log
    and the library are written in a directory of this process's own,
    removed at the end; the library and the log reach the digest's
    directory by ``os.replace`` (whole files only, the last process's
    winning: every process that builds one digest links the same
    sources)."""
    global BUILD_SECONDS
    out = BUILD_ROOT / _digest()
    lib = out / "libfantoch_kernels.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix=f".build-{os.getpid()}-", dir=out))
    try:
        flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", f"-I{CSRC}"]
        procs = []
        for src in _sources():
            obj = work / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        log = []
        failed = []
        for src, _obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (work / "nvcc.log").write_text("\n".join(log))
        os.replace(work / "nvcc.log", out / "nvcc.log")
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log)
            )
        built = work / lib.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(built),
             *[str(o) for _s, o, _p in procs]],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"link failed:\n{link.stdout}{link.stderr}")
        os.replace(built, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
    ``(pointers, KM)`` — the hash, count and guard planes, which the
    kernel updates in place, and the key capacity. When ``ps`` carries no
    monitor planes: three null pointers and 0."""
    import torch

    if MON_PS_KEYS[0] not in ps:
        return [0] * 3, 0
    KM = ps["_mon_hash"].shape[2]
    check("ps/_mon_hash", ps["_mon_hash"], torch.int32, (L, N, KM), device)
    check("ps/_mon_cnt", ps["_mon_cnt"], torch.int32, (L, N, KM), device)
    check("ps/_mon_flags", ps["_mon_flags"], torch.int32, (L, N), device)
    return [ps[k].data_ptr() for k in MON_PS_KEYS], KM
