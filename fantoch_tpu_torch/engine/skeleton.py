"""The union state skeleton of mixed-protocol batches.

The port's own copy of the reference's ``engine/skeleton.py`` (it may
import nothing of it). A mixed batch's lanes carry different state and
ctx trees, one per protocol; the reference packs them all into one
union tree so one ``lax.switch`` can step them. The port steps each
protocol's lanes on their own, at their native extents
(``engine/hetero.py``), and keeps the skeleton for what does not depend
on the layout:

- :func:`classify_planes` decides, per dotted state/ctx plane, how the
  union stores it: ``SHARED`` (same rank and dtype in every audit, at
  the elementwise-max extent), ``CASTABLE`` (same rank everywhere,
  stored in a dtype every native dtype casts to losslessly) or
  ``PRIVATE`` (a slot per audit);
- :func:`build_skeleton` turns the verdicts into a :class:`Skeleton`,
  and :func:`skeleton_fingerprint` hashes it, byte for byte the
  reference's hash of the same trees;
- :func:`pack_state` / :func:`unpack_state` (and the ``ctx`` twins)
  move one audit's native tree into the union tree and back, exactly,
  for numpy arrays and torch tensors, refusing by name any plane the
  skeleton does not know.

``lead`` leading axes (a lane axis: ``lead=1``) ride in front of every
plane's native shape; the checks compare the shapes behind them.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# plane verdicts
SHARED = "SHARED"        # every audit: same rank, same dtype; pad to max
CASTABLE = "CASTABLE"    # every audit: same rank; storage dtype widened
PRIVATE = "PRIVATE"      # protocol-specific: per-audit slot in the union
VERDICTS = (SHARED, CASTABLE, PRIVATE)


class SkeletonMismatchError(RuntimeError):
    """A tree handed to the pack/unpack adapters disagrees with the
    skeleton (unknown plane, missing plane, drifted shape or dtype,
    foreign ``protocol_id``). Always refused by name: a silently
    truncated or zero-filled plane would be a wrong result."""


def canonical_json(obj) -> str:
    """The reference's one JSON serialization of hashed specs
    (``engine/checkpoint.py canonical_json``): sorted keys."""
    return json.dumps(obj, sort_keys=True)


# ----------------------------------------------------------------------
# dotted-plane walking (dict-only trees, the engine's state/ctx shape)
# ----------------------------------------------------------------------

def walk_planes(tree, prefix: str) -> Dict[str, Any]:
    """Flatten a nested-dict tree into ``{dotted-name: leaf}`` with
    ``prefix`` as the root segment (``state.ps.clock``,
    ``ctx.delay_pp``). Any other container, and any key with a ``.``,
    is refused by name so dotted paths stay invertible."""
    out: Dict[str, Any] = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                if not isinstance(k, str) or "." in k:
                    raise SkeletonMismatchError(
                        f"skeleton planes need dot-free string keys; "
                        f"got {k!r} under {path}"
                    )
                rec(node[k], f"{path}.{k}")
        elif isinstance(node, (list, tuple)):
            raise SkeletonMismatchError(
                f"skeleton trees are nested dicts of arrays; {path} "
                f"is a {type(node).__name__}"
            )
        else:
            out[path] = node

    rec(tree, prefix)
    return out


def unflatten_planes(leaves: Mapping[str, Any]) -> dict:
    """Invert :func:`walk_planes` (names WITHOUT the root prefix)."""
    root: dict = {}
    for name in sorted(leaves):
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaves[name]
    return root


# ----------------------------------------------------------------------
# classification over per-audit plane specs
# ----------------------------------------------------------------------

def _lossless_cast(src: np.dtype, dst: np.dtype) -> bool:
    """True iff every value of ``src`` survives a round trip through
    ``dst``: an integer → float widen needs the mantissa to cover the
    integer's value bits."""
    if src == dst:
        return True
    if src.kind in "iu" and dst.kind == "f":
        value_bits = src.itemsize * 8 - (1 if src.kind == "i" else 0)
        return value_bits <= np.finfo(dst).nmant
    return np.can_cast(src, dst, casting="safe")


def classify_planes(
    specs: Mapping[str, Mapping[str, Tuple[tuple, str]]],
) -> Dict[str, dict]:
    """Classify every plane of ``{audit: {name: (shape, dtype)}}``
    against the cross-audit union: ``{name: entry}``, an entry carrying
    ``verdict``, per-audit ``native`` specs and, for SHARED/CASTABLE,
    the ``union`` storage spec."""
    audits = sorted(specs)
    assert audits, "classify_planes needs at least one audit"
    names = sorted({n for a in audits for n in specs[a]})
    entries: Dict[str, dict] = {}
    for name in names:
        native = {
            a: {
                "shape": [int(d) for d in specs[a][name][0]],
                "dtype": str(specs[a][name][1]),
            }
            for a in audits
            if name in specs[a]
        }
        entry: Dict[str, Any] = {"native": native}
        ranks = {len(v["shape"]) for v in native.values()}
        dtypes = sorted({v["dtype"] for v in native.values()})
        if len(native) < len(audits) or len(ranks) != 1:
            # absent from some audit, or the rank disagrees: a slot per
            # audit
            entry["verdict"] = PRIVATE
        else:
            shape = [
                max(v["shape"][i] for v in native.values())
                for i in range(ranks.pop())
            ]
            if len(dtypes) == 1:
                entry["verdict"] = SHARED
                entry["union"] = {"shape": shape, "dtype": dtypes[0]}
            else:
                try:
                    union_dt = np.dtype(dtypes[0])
                    for d in dtypes[1:]:
                        union_dt = np.promote_types(union_dt, d)
                    lossless = all(
                        _lossless_cast(np.dtype(d), union_dt)
                        for d in dtypes
                    )
                except TypeError:
                    lossless = False
                if lossless:
                    entry["verdict"] = CASTABLE
                    entry["union"] = {
                        "shape": shape,
                        "dtype": str(union_dt),
                    }
                else:
                    # no value-preserving widen exists
                    entry["verdict"] = PRIVATE
        entries[name] = entry
    return entries


# ----------------------------------------------------------------------
# the skeleton
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Skeleton:
    """The union: ordered audits (index = ``protocol_id``) and
    classified planes."""

    audits: Tuple[str, ...]
    planes: Mapping[str, dict]

    def protocol_id(self, audit: str) -> int:
        try:
            return self.audits.index(audit)
        except ValueError:
            raise SkeletonMismatchError(
                f"audit {audit!r} is not in this skeleton's grid "
                f"{list(self.audits)}"
            ) from None

    def slots(self, prefix: str):
        """``(sub-name, entry)`` pairs under ``prefix`` ("state" or
        "ctx"), sub-names stripped of the prefix, sorted."""
        p = prefix + "."
        for name in sorted(self.planes):
            if name.startswith(p):
                yield name[len(p):], self.planes[name]


def build_skeleton(entries: Mapping[str, dict], audits=None) -> Skeleton:
    """A :class:`Skeleton` from classified plane entries. Unknown
    verdicts, SHARED/CASTABLE entries without a union spec and native
    specs of audits outside the grid are refused by name."""
    if audits is None:
        audits = sorted(
            {a for e in entries.values() for a in e.get("native", {})}
        )
    audits = tuple(audits)
    for name, ent in sorted(entries.items()):
        v = ent.get("verdict")
        if v not in VERDICTS:
            raise SkeletonMismatchError(
                f"plane {name}: unknown verdict {v!r}"
            )
        if v in (SHARED, CASTABLE) and not ent.get("union"):
            raise SkeletonMismatchError(
                f"plane {name}: {v} without a union storage spec"
            )
        if not ent.get("native"):
            raise SkeletonMismatchError(f"plane {name}: no native specs")
        stray = sorted(set(ent["native"]) - set(audits))
        if stray:
            raise SkeletonMismatchError(
                f"plane {name}: native specs for audits outside the "
                f"grid: {stray}"
            )
    return Skeleton(audits=audits, planes=dict(entries))


def skeleton_fingerprint(skeleton: Skeleton) -> str:
    """Content hash of the union spec (audit order and every slot's
    verdict, union and native shapes and dtypes): the reference's hash
    of the same skeleton."""
    spec = {
        "audits": list(skeleton.audits),
        "planes": {
            name: {
                "verdict": ent["verdict"],
                **({"union": ent["union"]} if ent.get("union") else {}),
                "native": ent["native"],
            }
            for name, ent in skeleton.planes.items()
        },
    }
    return hashlib.sha256(canonical_json(spec).encode()).hexdigest()


def packed_spec(skeleton: Skeleton, prefix: str = "state") -> dict:
    """Shape/dtype spec of the packed union tree, the same for every
    audit: ``shared`` slots at union extents, ``priv`` per-audit slots
    at native extents, and for the state tree the ``protocol_id``
    plane."""
    shared: Dict[str, tuple] = {}
    priv: Dict[str, Dict[str, tuple]] = {a: {} for a in skeleton.audits}
    for sub, ent in skeleton.slots(prefix):
        if ent["verdict"] == PRIVATE:
            for a, nat in sorted(ent["native"].items()):
                priv[a][sub] = (tuple(nat["shape"]), nat["dtype"])
        else:
            u = ent["union"]
            shared[sub] = (tuple(u["shape"]), u["dtype"])
    spec: Dict[str, Any] = {"shared": shared, "priv": priv}
    if prefix == "state":
        spec["protocol_id"] = ((), "int32")
    return spec


# ----------------------------------------------------------------------
# array operations for numpy arrays and torch tensors alike
# ----------------------------------------------------------------------

def dtype_name(arr) -> str:
    """The numpy name of ``arr``'s dtype (``int32``, ``bool``, ...)."""
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).rsplit(".", 1)[-1]
    return str(np.asarray(arr).dtype)


def _astype(arr, name: str):
    if isinstance(arr, torch.Tensor):
        return arr.to(getattr(torch, name))
    return np.asarray(arr).astype(name)


def _zeros(shape, name: str, like):
    if isinstance(like, torch.Tensor):
        return torch.zeros(shape, dtype=getattr(torch, name),
                           device=like.device)
    return np.zeros(shape, dtype=name)


def _pad_to(arr, shape, lead: int):
    """Zero-pad the planes behind ``lead`` axes up to ``shape``."""
    have = tuple(arr.shape[lead:])
    if have == tuple(shape):
        return arr
    if any(t < s for s, t in zip(have, shape)):
        raise SkeletonMismatchError(
            f"cannot pad {have} down to {tuple(shape)}"
        )
    if isinstance(arr, torch.Tensor):
        out = torch.zeros(tuple(arr.shape[:lead]) + tuple(shape),
                          dtype=arr.dtype, device=arr.device)
    else:
        out = np.zeros(tuple(arr.shape[:lead]) + tuple(shape), arr.dtype)
    out[(Ellipsis,) + tuple(slice(0, s) for s in have)] = arr
    return out


# ----------------------------------------------------------------------
# pack / unpack: exact round trip, refusal by name
# ----------------------------------------------------------------------

def _pack_tree(skeleton: Skeleton, audit: str, tree, prefix: str,
               lead: int):
    skeleton.protocol_id(audit)  # a foreign audit, before any plane
    leaves = walk_planes(tree, prefix)
    like = next(iter(leaves.values()), None)
    lanes = tuple(like.shape[:lead]) if like is not None else ()
    shared: Dict[str, Any] = {}
    priv: Dict[str, Dict[str, Any]] = {a: {} for a in skeleton.audits}
    for sub, ent in skeleton.slots(prefix):
        name = f"{prefix}.{sub}"
        nat = ent["native"].get(audit)
        arr = None
        if nat is not None:
            if name not in leaves:
                raise SkeletonMismatchError(
                    f"{audit}: {prefix} tree is missing plane {name} "
                    f"the skeleton expects"
                )
            arr = leaves.pop(name)
            if not isinstance(arr, torch.Tensor):
                arr = np.asarray(arr)
            if (tuple(arr.shape[lead:]) != tuple(nat["shape"])
                    or dtype_name(arr) != nat["dtype"]):
                raise SkeletonMismatchError(
                    f"{audit}: plane {name} is "
                    f"{tuple(arr.shape[lead:])}/{dtype_name(arr)}, "
                    f"skeleton native spec says "
                    f"{tuple(nat['shape'])}/{nat['dtype']}"
                )
        elif name in leaves:
            raise SkeletonMismatchError(
                f"{audit}: plane {name} is not carried by this audit "
                f"in the skeleton, yet the {prefix} tree has it"
            )
        if ent["verdict"] == PRIVATE:
            # every audit's slot exists in every lane: the other
            # audits' are zero
            for a, na in sorted(ent["native"].items()):
                if a == audit and arr is not None:
                    priv[a][sub] = arr
                else:
                    priv[a][sub] = _zeros(
                        lanes + tuple(na["shape"]), na["dtype"], like
                    )
        else:
            u = ent["union"]
            shared[sub] = _astype(_pad_to(arr, u["shape"], lead),
                                  u["dtype"])
    if leaves:
        raise SkeletonMismatchError(
            f"{audit}: {prefix} tree carries planes the skeleton does "
            f"not know (would be silently dropped): {sorted(leaves)}"
        )
    return {"shared": shared, "priv": priv}


def _unpack_tree(skeleton: Skeleton, audit: str, packed, prefix: str,
                 lead: int):
    for part in ("shared", "priv"):
        if part not in packed:
            raise SkeletonMismatchError(
                f"{audit}: packed {prefix} tree has no {part!r} slot"
            )
    out: Dict[str, Any] = {}
    for sub, ent in skeleton.slots(prefix):
        nat = ent["native"].get(audit)
        if nat is None:
            continue
        if ent["verdict"] == PRIVATE:
            try:
                arr = packed["priv"][audit][sub]
            except KeyError:
                raise SkeletonMismatchError(
                    f"{audit}: packed tree is missing private slot "
                    f"{prefix}.{sub}"
                ) from None
        else:
            u = ent["union"]
            try:
                arr = packed["shared"][sub]
            except KeyError:
                raise SkeletonMismatchError(
                    f"{audit}: packed tree is missing shared slot "
                    f"{prefix}.{sub}"
                ) from None
            if (tuple(arr.shape[lead:]) != tuple(u["shape"])
                    or dtype_name(arr) != u["dtype"]):
                raise SkeletonMismatchError(
                    f"{audit}: shared slot {prefix}.{sub} is "
                    f"{tuple(arr.shape[lead:])}/{dtype_name(arr)}, union "
                    f"spec says {tuple(u['shape'])}/{u['dtype']}"
                )
            arr = arr[(Ellipsis,) + tuple(slice(0, s) for s in nat["shape"])]
        arr = _astype(arr, nat["dtype"])
        if tuple(arr.shape[lead:]) != tuple(nat["shape"]):
            raise SkeletonMismatchError(
                f"{audit}: slot {prefix}.{sub} unpacked to "
                f"{tuple(arr.shape[lead:])}, native spec says "
                f"{tuple(nat['shape'])}: the union extent does not "
                f"cover the native extent"
            )
        out[sub] = arr
    return unflatten_planes(out)


def pack_state(skeleton: Skeleton, audit: str, state, *, lead: int = 0):
    """Pack one audit's native state into the union: SHARED/CASTABLE
    planes zero-padded to union extents and widened to union storage,
    PRIVATE planes into this audit's slots (every other audit's slots
    zero), plus the ``protocol_id`` plane (int32, one a lane). Numpy in,
    numpy out; tensors in, tensors out on their device."""
    packed = _pack_tree(skeleton, audit, state, "state", lead)
    leaves = walk_planes(state, "state")
    like = next(iter(leaves.values()), None)
    pid = skeleton.protocol_id(audit)
    lanes = tuple(like.shape[:lead]) if like is not None else ()
    if isinstance(like, torch.Tensor):
        packed["protocol_id"] = torch.full(lanes, pid, dtype=torch.int32,
                                           device=like.device)
    else:
        packed["protocol_id"] = np.full(lanes, pid, dtype=np.int32)
    return packed


def unpack_state(skeleton: Skeleton, audit: str, packed, *,
                 lead: int = 0):
    """Invert :func:`pack_state` for ``audit``: padded planes sliced
    back to native extents, widened storage cast back to native dtypes.
    A ``protocol_id`` that names another audit is refused by name."""
    pid = packed.get("protocol_id")
    if pid is None:
        raise SkeletonMismatchError(
            f"{audit}: packed state has no protocol_id plane"
        )
    want = skeleton.protocol_id(audit)
    got = sorted({int(x) for x in np.asarray(
        pid.cpu() if isinstance(pid, torch.Tensor) else pid).reshape(-1)})
    for g in got:
        if g != want:
            name = (skeleton.audits[g] if 0 <= g < len(skeleton.audits)
                    else "?")
            raise SkeletonMismatchError(
                f"packed state carries protocol_id {g} ({name}), but "
                f"unpack was asked for {audit!r} (id {want})"
            )
    return _unpack_tree(skeleton, audit, packed, "state", lead)


def pack_ctx(skeleton: Skeleton, audit: str, ctx, *, lead: int = 0):
    """The ctx twin of :func:`pack_state` (no ``protocol_id``)."""
    return _pack_tree(skeleton, audit, ctx, "ctx", lead)


def unpack_ctx(skeleton: Skeleton, audit: str, packed, *, lead: int = 0):
    """The ctx twin of :func:`unpack_state`."""
    return _unpack_tree(skeleton, audit, packed, "ctx", lead)
