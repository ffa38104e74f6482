"""Durable checkpoints of a sweep batch, with bit-exact resume.

The port's own copy of the reference's host code
(``fantoch_tpu/engine/checkpoint.py``): ``save_sweep_checkpoint``
writes a batch's whole lane state, taken at a drained window boundary,
and the sha256 of its ctx to a versioned host artifact (an npz payload
and a JSON manifest); ``load_sweep_checkpoint`` restores it bit for
bit, so a run
checkpointed at a window boundary and resumed gives byte-identical
``LaneResults`` to an uninterrupted run (the device loop advances the
state deterministically, and the host round trip keeps every bit).

A stale artifact is refused, never misloaded. The manifest carries a
signature of what bit-exact resume depends on, and a mismatch in any
part raises :class:`CheckpointMismatchError` naming it. Where the
reference hashes the step's jaxpr, the port's signature
(:func:`step_signature`) holds the protocol's identity, the dims, the
run flags, the torch version and ``step_source_sha256``: the sha256 of
the sources that define the step (``engine/core.py``, the protocol's
modules, ``kernels/*.py`` and ``kernels/csrc/*``, in a fixed order).
Its ``kind`` is ``fantoch-tpu-torch-checkpoint``, as is the manifest's,
so an artifact of the reference is refused by ``kind`` here and the
reference refuses the port's the same way. A truncated or tampered
payload fails its recorded sha256 (:class:`CheckpointCorruptError`).
The loader also compares the saved ctx digest with that of the ctx
built fresh for the run, so a checkpoint never resumes onto other
lanes. (The reference stores the ctx itself with every save; it never
changes during a run, so the port stores only its digest.)

Artifact layout (a directory)::

    <path>/manifest.json        # version, signature, meta (with the
                                # ctx's sha256), payload ref
    <path>/payload-<sha12>.npz  # every state leaf, flat-keyed

The payload is written and renamed into place before the manifest that
names it, each rename atomic, so a kill mid-save leaves the previous
consistent pair or the new one.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

CHECKPOINT_KIND = "fantoch-tpu-torch-checkpoint"
CHECKPOINT_VERSION = 1

_MANIFEST = "manifest.json"
_PKG = Path(__file__).resolve().parent.parent


class CheckpointError(RuntimeError):
    """Base class: a checkpoint could not be used. Never caught
    silently; callers surface the reason and refuse to resume."""


class CheckpointMismatchError(CheckpointError):
    """The checkpoint is stale: written under another protocol, dims,
    torch version, step source, run flags or lane grid than the run
    resuming from it, or by another program (``kind``). The
    mismatched parts are named."""


class CheckpointCorruptError(CheckpointError):
    """The artifact itself is damaged: an unreadable manifest, a
    missing payload, or a payload whose bytes fail the recorded
    sha256."""


class SweepInterrupted(RuntimeError):
    """``run_sweep`` stopped at a window boundary with its state saved
    (a signal, the wall-clock budget or the window limit). The
    checkpoint at ``path`` resumes the run where it stopped."""

    def __init__(self, path: str, until: int, reason: str):
        self.path = path
        self.until = int(until)
        self.reason = reason
        super().__init__(
            f"sweep interrupted ({reason}) at step {until}; checkpoint "
            f"saved at {path}"
        )


@dataclass
class CheckpointSpec:
    """How ``run_sweep`` checkpoints.

    path
        artifact directory (created at the first save).
    every
        windows between saves (1 = every window boundary); a window is
        one device call, ``scan_window`` segments.
    resume
        load a valid checkpoint at ``path`` before running (a stale or
        corrupt one is refused by name, never ignored).
    keep
        keep the artifact after the run completes (default: removed,
        the results are the durable output then).
    budget_s
        wall-clock seconds from the start of the window loop; once past
        them the run saves and raises :class:`SweepInterrupted` at the
        next window boundary.
    stop_after_segments
        save and raise after this many windows (with ``scan_window=1``
        a window is one segment).
    """

    path: str
    every: int = 1
    resume: bool = True
    keep: bool = False
    budget_s: Optional[float] = None
    stop_after_segments: Optional[int] = None


# ----------------------------------------------------------------------
# signatures: what bit-exact resume depends on
# ----------------------------------------------------------------------

def protocol_ident(protocol) -> str:
    """A device protocol's identity: its class path and the attributes
    that shape its step (device protocols have value identity,
    ``protocols/identity.py``)."""
    cls = protocol if isinstance(protocol, type) else type(protocol)
    ident = f"{cls.__module__}.{cls.__qualname__}"
    if not isinstance(protocol, type):
        ident += repr(sorted(vars(protocol).items()))
    return ident


def step_sources(protocols: Iterable) -> list:
    """The package files that define the step of ``protocols``, in a
    fixed order: ``engine/core.py``, each protocol class's modules (its
    own and its bases' in the package), ``kernels/*.py`` and
    ``kernels/csrc/*``."""
    files = {_PKG / "engine" / "core.py"}
    for p in protocols:
        cls = p if isinstance(p, type) else type(p)
        for base in cls.__mro__:
            mod = base.__module__
            if mod.split(".")[0] == _PKG.name:
                files.add(_PKG.joinpath(*mod.split(".")[1:]).with_suffix(
                    ".py"))
    files.update((_PKG / "kernels").glob("*.py"))
    files.update(p for p in (_PKG / "kernels" / "csrc").glob("*")
                 if p.is_file())
    return sorted(files, key=lambda p: p.relative_to(_PKG).as_posix())


def step_source_sha256(protocols: Iterable) -> str:
    """sha256 over :func:`step_sources`, each file's package-relative
    path and bytes."""
    h = hashlib.sha256()
    for path in step_sources(protocols):
        h.update(path.relative_to(_PKG).as_posix().encode() + b"\0")
        h.update(path.read_bytes() + b"\0")
    return h.hexdigest()


def run_flags(reorder: bool, faults, monitor_keys: int) -> Dict[str, str]:
    """The signature's run-flag parts and the torch version."""
    return {
        "kind": CHECKPOINT_KIND,
        "torch": torch.__version__,
        "reorder": repr(bool(reorder)),
        "faults": repr(faults),
        "monitor_keys": repr(int(monitor_keys)),
    }


def step_signature(protocol, dims, *, reorder: bool, faults,
                   monitor_keys: int) -> Dict[str, str]:
    """The signature a native batch's manifest stores and is checked
    against. ``skeleton`` is empty: a mixed batch's signature
    (``engine/hetero.py hetero_step_signature``) carries its
    fingerprint there, so a resume across the two is refused by that
    name."""
    return {
        **run_flags(reorder, faults, monitor_keys),
        "protocol": protocol_ident(protocol),
        "dims": repr(dims),
        "skeleton": "",
        "step_source_sha256": step_source_sha256([protocol]),
    }


# ----------------------------------------------------------------------
# trees <-> flat npz keys
# ----------------------------------------------------------------------

def _flatten_tree(tree, prefix: str) -> Dict[str, np.ndarray]:
    """Nested dict of arrays (numpy or tensors) -> flat
    ``prefix/key/.../leaf`` numpy arrays, keys in sorted order."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_tree(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten_tree(flat: Dict[str, np.ndarray], prefix: str) -> dict:
    """Inverse of :func:`_flatten_tree` for dict-of-dicts trees."""
    root: dict = {}
    want = prefix + "/"
    for key in sorted(flat):
        if not key.startswith(want):
            continue
        parts = key[len(want):].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return root


# ----------------------------------------------------------------------
# raw artifact I/O
# ----------------------------------------------------------------------

def checkpoint_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, _MANIFEST))


def atomic_write(path: str, data: "bytes | str") -> None:
    """Crash-safe file write: a temp file in the same directory (its
    name pid-unique), flushed and fsynced, then an atomic rename."""
    tmp = f"{path}.{os.getpid()}.tmp"
    mode = "wb" if isinstance(data, bytes) else "w"
    with open(tmp, mode) as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def canonical_json(obj, *, indent=None) -> str:
    """The JSON every artifact is written in: keys sorted, floats
    through the stdlib's ``repr``."""
    return json.dumps(obj, indent=indent, sort_keys=True)


def save_artifact(path: str, arrays: Dict[str, np.ndarray],
                  signature: Dict[str, str], meta: dict) -> int:
    """Atomic write: the payload first (under a name derived from its
    own hash), then the manifest naming it, so a kill at any instant
    leaves a loadable artifact. Returns the payload's bytes."""
    os.makedirs(path, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    digest = hashlib.sha256(payload).hexdigest()
    pname = f"payload-{digest[:12]}.npz"
    atomic_write(os.path.join(path, pname), payload)
    manifest = {
        "kind": CHECKPOINT_KIND,
        "version": CHECKPOINT_VERSION,
        "signature": signature,
        "payload": pname,
        "payload_sha256": digest,
        "meta": meta,
    }
    atomic_write(os.path.join(path, _MANIFEST),
                 canonical_json(manifest, indent=2))
    # earlier payloads are unreferenced once the manifest lands
    for fn in os.listdir(path):
        if fn.startswith("payload-") and fn != pname:
            try:
                os.remove(os.path.join(path, fn))
            except OSError:
                pass
    return len(payload)


def load_artifact(path: str,
                  expected_signature: "Dict[str, str] | None" = None,
                  ) -> "tuple[Dict[str, np.ndarray], dict]":
    """Read and verify an artifact: ``(flat arrays, manifest)``, or the
    named refusal."""
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(f"no checkpoint manifest at {path}")
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint manifest unreadable at {mpath}: {e}"
        ) from e
    if not isinstance(manifest, dict):
        raise CheckpointCorruptError(
            f"checkpoint manifest unreadable at {mpath}: not an object")
    if manifest.get("kind") != CHECKPOINT_KIND:
        raise CheckpointMismatchError(
            f"not a {CHECKPOINT_KIND} artifact: kind="
            f"{manifest.get('kind')!r}"
        )
    if manifest.get("version") != CHECKPOINT_VERSION:
        raise CheckpointMismatchError(
            f"checkpoint version {manifest.get('version')!r} != "
            f"supported {CHECKPOINT_VERSION}"
        )
    if expected_signature is not None:
        saved = manifest.get("signature") or {}
        bad = sorted(k for k in set(expected_signature) | set(saved)
                     if saved.get(k) != expected_signature.get(k))
        if bad:
            detail = "; ".join(
                f"{k}: saved {str(saved.get(k))[:80]!r} != current "
                f"{str(expected_signature.get(k))[:80]!r}"
                for k in bad
            )
            raise CheckpointMismatchError(
                f"stale checkpoint refused ({', '.join(bad)} changed "
                f"since it was written): {detail}"
            )
    pname = manifest.get("payload")
    ppath = os.path.join(path, str(pname))
    if not pname or not os.path.exists(ppath):
        raise CheckpointCorruptError(
            f"checkpoint payload {pname!r} missing from {path}"
        )
    with open(ppath, "rb") as fh:
        payload = fh.read()
    digest = hashlib.sha256(payload).hexdigest()
    if digest != manifest.get("payload_sha256"):
        raise CheckpointCorruptError(
            f"checkpoint payload {pname} truncated or corrupted: "
            f"sha256 {digest[:12]}... != recorded "
            f"{str(manifest.get('payload_sha256'))[:12]}..."
        )
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as npz:
            arrays = {k: npz[k] for k in npz.files}
    except Exception as e:  # zipfile/format errors vary by numpy
        raise CheckpointCorruptError(
            f"checkpoint payload {pname} unreadable: {e}"
        ) from e
    return arrays, manifest


def discard_checkpoint(path: str) -> None:
    """Remove an artifact this module wrote (manifest, payloads, left
    temp files; the directory itself if then empty)."""
    if not os.path.isdir(path):
        return
    for fn in os.listdir(path):
        if fn == _MANIFEST or fn.startswith("payload-") or (
            fn.startswith(_MANIFEST) and fn.endswith(".tmp")
        ):
            try:
                os.remove(os.path.join(path, fn))
            except OSError:
                pass
    try:
        os.rmdir(path)
    except OSError:
        pass


# ----------------------------------------------------------------------
# sweep-level wrappers
# ----------------------------------------------------------------------

def ctx_sha256(ctx) -> str:
    """sha256 over a ctx tree (numpy arrays or tensors): each flat key,
    dtype and shape, and the leaf's bytes, keys in sorted order."""
    h = hashlib.sha256()
    for k, v in _flatten_tree(ctx, "ctx").items():
        h.update(f"{k}|{v.dtype.str}|{v.shape}".encode() + b"\0")
        h.update(np.ascontiguousarray(v).tobytes() + b"\0")
    return h.hexdigest()


def save_sweep_checkpoint(path: str, *, state, ctx_digest: str,
                          signature: Dict[str, str], until: int,
                          meta: dict) -> int:
    """Write one batch's whole state (a host tree: numpy arrays or CPU
    tensors, taken at a drained window boundary) and its ctx's
    :func:`ctx_sha256`. Returns the payload's bytes."""
    return save_artifact(path, _flatten_tree(state, "state"), signature,
                         dict(meta, until=int(until), ctx_sha256=ctx_digest))


def load_sweep_checkpoint(path: str, *, signature: Dict[str, str],
                          ctx_digest: str,
                          meta_expect: "dict | None" = None,
                          ) -> "tuple[dict, dict]":
    """Restore a sweep checkpoint: the signature, the meta, the
    payload's integrity, and the saved ctx digest against that of the
    ctx built fresh for this run (``ctx_digest``, its
    :func:`ctx_sha256`), so a checkpoint never resumes onto other
    lanes. Returns ``(state numpy tree, manifest meta)``."""
    arrays, manifest = load_artifact(path, signature)
    meta = manifest.get("meta") or {}
    for k, v in (meta_expect or {}).items():
        if meta.get(k) != v:
            raise CheckpointMismatchError(
                f"checkpoint {k}={meta.get(k)!r} does not match the "
                f"current run's {k}={v!r}"
            )
    if meta.get("ctx_sha256") != ctx_digest:
        raise CheckpointMismatchError(
            f"checkpoint lane ctx (sha256 "
            f"{str(meta.get('ctx_sha256'))[:12]}...) differs from the "
            f"current specs' ({ctx_digest[:12]}...): resuming onto "
            "different lanes is refused"
        )
    return _unflatten_tree(arrays, "state"), meta
