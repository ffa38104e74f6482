"""Workload key generators (the reference's ``fantoch/src/client/key_gen.rs``).

Two generators of the reference: ``ConflictPool`` (with probability
``conflict_rate``% a random key of a shared pool of ``CONFLICT<i>`` keys,
else the client's private key; key_gen.rs:96-110) and ``Zipf`` over a
fixed key universe (key_gen.rs:113-119). They draw from an explicit
``random.Random`` so simulations are reproducible.

``DeviceStream`` replays the device engine's counter-based key stream on
the host, so the oracle and the engine run the same workload: its keys
come from the plain twin of the key-table kernel
(``kernels/key_table.py key_table_plain``) on CPU tensors.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from ..core.ids import ClientId
from ..core.kvs import Key

CONFLICT_COLOR = "CONFLICT"


@dataclass(frozen=True)
class ConflictPool:
    conflict_rate: int  # percentage 0..=100
    pool_size: int = 1

    def __str__(self) -> str:
        return f"conflict_{self.conflict_rate}_{self.pool_size}"


@dataclass(frozen=True)
class Zipf:
    coefficient: float
    total_keys_per_shard: int

    def __str__(self) -> str:
        return f"zipf_{self.coefficient:.2f}_{self.total_keys_per_shard}".replace(
            ".", "-"
        )


@dataclass(frozen=True)
class DeviceStream:
    """The device engine's counter-based threefry key stream, replayed on
    the host (``engine/spec.py`` lanes draw the same keys through K3).
    Keys are the device's integer keys stringified: pool keys
    ``0..pool_size-1`` (or Zipf ranks), private key ``pool_size +
    client_index``.

    ``traffic`` attaches a time-varying schedule
    (:class:`fantoch_tpu_torch.traffic.TrafficSchedule`): the stream then
    draws under the schedule's epoch tables, as the device lane does
    (conflict rate, pool size, hot-key rotation on the exact command
    seq, private keys from ``pool_span + client``). The per-command read
    flag is drawn from the same counter stream (fold 3) against the
    epoch's ``read_pct``; the engine carries no GET/PUT distinction, so
    the flag only shapes the mirrored workload's ops."""

    conflict_rate: int = 100
    pool_size: int = 1
    zipf: Optional[tuple] = None  # (coefficient, total_keys)
    seed: int = 0
    traffic: Optional[object] = None  # TrafficSchedule (hashable)

    def __str__(self) -> str:
        if self.zipf:
            return f"devstream_zipf_{self.zipf[0]:.2f}_{self.zipf[1]}"
        if self.traffic is not None:
            return (
                f"devstream_traffic_{self.traffic.name}_"
                f"{self.conflict_rate}_{self.pool_size}"
            )
        return f"devstream_{self.conflict_rate}_{self.pool_size}"


KeyGen = Union[ConflictPool, Zipf, DeviceStream]


def zipf_weights(key_count: int, coefficient: float) -> np.ndarray:
    """P(k) ∝ 1 / k^coefficient for k in 1..=key_count, matching the zipf
    crate used by the reference (client/key_gen.rs:62-77)."""
    ranks = np.arange(1, key_count + 1, dtype=np.float64)
    weights = 1.0 / np.power(ranks, coefficient)
    return weights / weights.sum()


def _stream_ctx(kg: DeviceStream, need: int) -> dict:
    """One lane's key-table inputs for ``kg`` as CPU tensors (``[1, ...]``),
    the epoch tables compiled to cover seqs below ``need``."""
    import torch

    from .. import random as rnd

    if kg.zipf is None:
        kind, cum = 0, np.ones((1,), np.float32)
    else:
        coefficient, total_keys = kg.zipf
        kind = 1
        cum = np.cumsum(zipf_weights(total_keys, coefficient)).astype(
            np.float32)
    lane = lambda v, dt=torch.int32: torch.tensor(  # noqa: E731
        np.asarray(v)[None], dtype=dt)
    ctx = {
        "rng_key": torch.from_numpy(rnd.PRNGKey(kg.seed)[None].copy()),
        "conflict_rate": lane(kg.conflict_rate),
        "pool_size": lane(kg.pool_size),
        "key_gen_kind": lane(kind),
        "zipf_cum": lane(cum, torch.float32),
        "traffic": None,
    }
    if kg.traffic is not None:
        tables = dict(kg.traffic.compile(need))
        if kg.zipf is not None:
            tables.update(kg.traffic.zipf_tables(kg.zipf[0],
                                                 int(kg.zipf[1])))
        ctx["read_pct"] = np.asarray(tables.pop("traffic_read_pct"))
        ctx["seq_epoch"] = np.asarray(tables["traffic_seq_epoch"])
        tables.pop("traffic_think")
        ctx["traffic"] = {
            k: lane(v, torch.float32 if k == "traffic_zipf_cum"
                    else torch.int32)
            for k, v in tables.items()
        }
    return ctx


class KeyGenState:
    """Per-client generator state (key_gen.rs:54-120)."""

    _BATCH = 512  # device-stream keys computed per key-table call

    def __init__(self, key_gen: KeyGen, shard_count: int, client_id: ClientId,
                 rng: Optional[random.Random] = None):
        self.key_gen = key_gen
        self.client_id = client_id
        self.rng = rng if rng is not None else random.Random()
        if isinstance(key_gen, Zipf):
            key_count = key_gen.total_keys_per_shard * shard_count
            self._zipf_cum = np.cumsum(
                zipf_weights(key_count, key_gen.coefficient)
            )
        else:
            self._zipf_cum = None
        self._stream: list = []  # DeviceStream key cache
        self._reads: list = []   # per-seq read flags (traffic mirror)
        self._cmds_issued = 0
        self._stream_ctx = None

    def gen_cmd_key(self) -> Key:
        kg = self.key_gen
        if isinstance(kg, DeviceStream):
            return self._device_stream_key(kg)
        if isinstance(kg, ConflictPool):
            if true_if_random_is_less_than(kg.conflict_rate, self.rng):
                return f"{CONFLICT_COLOR}{self.rng.randrange(kg.pool_size)}"
            return str(self.client_id)
        # zipf: sample rank in 1..=key_count
        u = self.rng.random()
        rank = int(np.searchsorted(self._zipf_cum, u, side="right")) + 1
        return str(rank)

    def _device_stream_key(self, kg: DeviceStream) -> Key:
        """Next key of the device's (client, seq)-counter stream; seqs
        are 1-based like the engine's SUBMIT payloads. Computed in
        batches of ``_BATCH`` keys, each one call of K3's plain twin on
        CPU tensors; with a traffic schedule, its epoch tables are
        (re)compiled to cover the batch's seqs (a table entry is the
        schedule's unbounded seq → epoch function, so every table length
        agrees with the device lane's on the seqs within the budget)."""
        from .. import random as rnd
        from ..kernels.key_table import key_table_plain

        self._cmds_issued += 1
        while len(self._stream) < self._cmds_issued:
            lo = len(self._stream) + 1
            need = lo + self._BATCH + 1
            ctx = self._stream_ctx
            if ctx is None or (
                kg.traffic is not None and ctx["seq_epoch"].shape[0] < need
            ):
                ctx = self._stream_ctx = _stream_ctx(kg, need)
            client_index = self.client_id - 1
            # the table's columns are seqs 0..T-1 of clients 0..C-1: this
            # client's row, this batch's seqs
            table = key_table_plain(
                ctx["rng_key"], ctx["conflict_rate"], ctx["pool_size"],
                ctx["key_gen_kind"], ctx["zipf_cum"], client_index + 1,
                lo + self._BATCH, ctx["traffic"],
            )
            self._stream.extend(
                int(k) for k in table[0, client_index, lo:].tolist())
            if kg.traffic is not None:
                # the schedule's read mix, from the same counter stream
                # (fold 3; the key draws use folds 0..2), so which
                # commands are reads is a function of (seed, client, seq)
                k = rnd.PRNGKey(kg.seed).astype(np.int64)
                seqs = np.arange(lo, lo + self._BATCH, dtype=np.int64)
                k0, k1 = rnd.fold_in2(k[0], k[1], np.int64(client_index))
                k0, k1 = rnd.fold_in2(k0 + seqs * 0, k1 + seqs * 0, seqs)
                r0, r1 = rnd.fold_in2(k0, k1, seqs * 0 + 3)
                tbl = ctx["seq_epoch"]
                e = tbl[np.minimum(seqs, tbl.shape[0] - 1)]
                reads = rnd.randint2(r0, r1, seqs * 0 + 100) < \
                    ctx["read_pct"][e]
                self._reads.extend(bool(x) for x in reads)
        return str(self._stream[self._cmds_issued - 1])

    def traffic_read_only(self) -> Optional[bool]:
        """The schedule-driven read flag of the most recently drawn
        key's command (None without a traffic DeviceStream — the
        workload then falls back to its own ``read_only_percentage``
        draw). Counter-based, so it never consumes host RNG state."""
        kg = self.key_gen
        if not (isinstance(kg, DeviceStream) and kg.traffic is not None):
            return None
        return bool(self._reads[self._cmds_issued - 1])


def true_if_random_is_less_than(
    percentage: int, rng: random.Random
) -> bool:
    """key_gen.rs:122-128."""
    if percentage == 0:
        return False
    if percentage == 100:
        return True
    return rng.randrange(100) < percentage
