"""Protocol abstraction.

Capability parity with ``fantoch/src/protocol/``: the ``Protocol`` interface
(protocol/mod.rs:41-115), ``Action`` (mod.rs:196-205), ``BaseProcess``
(quorum membership from distance-sorted discovery, dot generation, fast/slow
path metrics; base.rs:10-204), per-dot command-info stores (info/mod.rs) and
the committed-clock GC tracker (gc/clock.rs:10-171).

Every concrete protocol here is the host *oracle* (one config at a time,
dict-based) the device engine is held to; its array twin lives in
``fantoch_tpu_torch/engine/protocols``, where ``handle`` becomes a batched
message-type dispatch over fixed-shape state, run by the CUDA kernels.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import (
    Dict,
    Generic,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
    TypeVar,
    Union,
)

from ..core.command import Command
from ..core.config import Config
from ..core.ids import Dot, DotGen, ProcessId, ShardId
from ..core.metrics import Metrics
from ..core.timing import SysTime


class ProtocolMetricsKind(Enum):
    """protocol/mod.rs:147-180."""

    FAST_PATH = "fast_path"
    SLOW_PATH = "slow_path"
    STABLE = "stable"
    COMMIT_LATENCY = "commit_latency"
    WAIT_CONDITION_DELAY = "wait_condition_delay"
    COMMITTED_DEPS_LEN = "committed_deps_len"


ProtocolMetrics = Metrics


@dataclass
class ToSend:
    """Send ``msg`` to every process in ``target`` (mod.rs:196-201)."""

    target: Set[ProcessId]
    msg: "Message"


@dataclass
class ToForward:
    """Deliver ``msg`` to self immediately — used to route work between
    worker roles within a process (mod.rs:202-205)."""

    msg: "Message"


Action = Union[ToSend, ToForward]


@dataclass
class Message:
    """Base class for protocol messages; concrete protocols define
    dataclass subclasses (one per reference message variant).

    ``WORKER`` is the ``MessageIndex`` analog (protocol/mod.rs:182-194
    routed through lib.rs:44-76's reserved indexes) used by the run
    layer to pick one of W protocol workers:

    - ``"dot"``: shift past the two reserved workers by the message's
      dot sequence (``worker_dot_index_shift``) — the default; dotless
      messages fall back to the GC worker;
    - ``"slot"``: shift by ``self.slot`` (FPaxos commanders);
    - ``"gc"``: reserved worker 0 (``GC_WORKER_INDEX``);
    - ``"leader"``: reserved worker 0 (``LEADER_WORKER_INDEX``);
    - ``"aux"``: reserved worker 1 (Tempo's clock-bump role, FPaxos's
      acceptor role).
    """

    WORKER = "dot"


class BaseProcess:
    """base.rs:10-204."""

    def __init__(
        self,
        process_id: ProcessId,
        shard_id: ShardId,
        config: Config,
        fast_quorum_size: int,
        write_quorum_size: int,
    ):
        # ids must be non-zero: processes lead with ballot `id` in the slow
        # path and 0 means "never been through phase-2" (base.rs:36-39)
        assert process_id != 0
        self.process_id = process_id
        self.shard_id = shard_id
        self.config = config
        self.fast_quorum_size = fast_quorum_size
        self.write_quorum_size = write_quorum_size
        self._all: Optional[List[ProcessId]] = None
        self._all_but_me: Optional[List[ProcessId]] = None
        self._fast_quorum: Optional[List[ProcessId]] = None
        self._write_quorum: Optional[List[ProcessId]] = None
        self._closest_shard_process: Dict[ShardId, ProcessId] = {}
        self.dot_gen = DotGen(process_id)
        self.metrics: ProtocolMetrics = Metrics()

    def discover(self, processes: Sequence[Tuple[ProcessId, ShardId]]) -> bool:
        """``processes`` is sorted by distance (base.rs:57-131). Processes
        of other shards must each be the closest of their shard."""
        my_shard = []
        self._closest_shard_process = {}
        for process_id, shard_id in processes:
            if shard_id == self.shard_id:
                my_shard.append(process_id)
            else:
                assert shard_id not in self._closest_shard_process
                self._closest_shard_process[shard_id] = process_id
        self._all = list(my_shard)
        self._all_but_me = [p for p in my_shard if p != self.process_id]
        fast = my_shard[: self.fast_quorum_size]
        write = my_shard[: self.write_quorum_size]
        self._fast_quorum = fast if len(fast) == self.fast_quorum_size else None
        self._write_quorum = (
            write if len(write) == self.write_quorum_size else None
        )
        return self._fast_quorum is not None and self._write_quorum is not None

    def next_dot(self) -> Dot:
        return self.dot_gen.next_id()

    def all(self) -> Set[ProcessId]:
        assert self._all is not None
        return set(self._all)

    def all_but_me(self) -> Set[ProcessId]:
        assert self._all_but_me is not None
        return set(self._all_but_me)

    def fast_quorum(self) -> Set[ProcessId]:
        assert self._fast_quorum is not None
        return set(self._fast_quorum)

    def fast_quorum_sorted(self) -> List[ProcessId]:
        """Fast quorum in distance order (closest first); the reference
        keeps a HashSet but protocols like Tempo rely only on membership."""
        assert self._fast_quorum is not None
        return list(self._fast_quorum)

    def write_quorum(self) -> Set[ProcessId]:
        assert self._write_quorum is not None
        return set(self._write_quorum)

    def closest_process(self, shard_id: ShardId) -> ProcessId:
        return self._closest_shard_process[shard_id]

    def closest_shard_process(self) -> Dict[ShardId, ProcessId]:
        return self._closest_shard_process

    # metrics (base.rs:184-203)
    def fast_path(self) -> None:
        self.metrics.aggregate(ProtocolMetricsKind.FAST_PATH, 1)

    def slow_path(self) -> None:
        self.metrics.aggregate(ProtocolMetricsKind.SLOW_PATH, 1)

    def stable(self, count: int) -> None:
        self.metrics.aggregate(ProtocolMetricsKind.STABLE, count)

    def collect_metric(self, kind: ProtocolMetricsKind, value: int) -> None:
        self.metrics.collect(kind, value)


I = TypeVar("I")


class CommandsInfo(Generic[I]):
    """Per-dot info store (protocol/info/mod.rs): creates per-command info
    records on demand and garbage-collects stable dots."""

    def __init__(self, info_factory):
        self._factory = info_factory
        self._infos: Dict[Dot, I] = {}

    def get(self, dot: Dot) -> I:
        info = self._infos.get(dot)
        if info is None:
            info = self._factory()
            self._infos[dot] = info
        return info

    def peek(self, dot: Dot) -> Optional[I]:
        return self._infos.get(dot)

    def gc(self, stable: List[Tuple[ProcessId, int, int]]) -> int:
        """Remove stable dots; returns how many were removed
        (info/mod.rs; used by the Stable metric)."""
        from ..core.ids import dots as expand

        count = 0
        for dot in expand(stable):
            if self._infos.pop(dot, None) is not None:
                count += 1
        return count

    def gc_single(self, dot: Dot) -> Optional[I]:
        """Remove ``dot``'s info, returning it for cleanup if present
        (LockedCommandsInfo::gc_single returns the removed record)."""
        return self._infos.pop(dot, None)

    def __len__(self) -> int:
        return len(self._infos)


# above-exact event set (the `threshold` crate's AboveExSet used by
# gc/clock.rs); interval-backed so huge vote ranges stay cheap
from ..core.intervals import IntervalSet as AEClockSet  # noqa: E402


class GCTrack:
    """Committed-clock intersection GC (``VClockGCTrack``,
    gc/clock.rs:10-138).

    The single GC role per process tracks (a) its own committed dots as an
    exact clock and (b) the committed frontiers advertised by every other
    process; a dot is *stable* (present everywhere) when it is at or below
    the meet of all frontiers. Newly stable dots are returned as compressed
    (process, start, end) ranges.
    """

    def __init__(self, process_id: ProcessId, shard_id: ShardId, n: int):
        from ..core.ids import process_ids

        self.process_id = process_id
        self.n = n
        self.ids = process_ids(shard_id, n)
        self.my_clock: Dict[ProcessId, AEClockSet] = {
            p: AEClockSet() for p in self.ids
        }
        self.all_but_me: Dict[ProcessId, Dict[ProcessId, int]] = {}
        self.previous_stable: Dict[ProcessId, int] = {p: 0 for p in self.ids}

    def clock_frontier(self) -> Dict[ProcessId, int]:
        return {p: c.frontier for p, c in self.my_clock.items()}

    def add_to_clock(self, dot: Dot) -> None:
        self.my_clock[dot.source].add(dot.sequence)

    def update_clock_of(
        self, from_: ProcessId, clock: Dict[ProcessId, int]
    ) -> None:
        """Join (max) — messages can be reordered (gc/clock.rs:51-63)."""
        current = self.all_but_me.setdefault(from_, dict(clock))
        for p, seq in clock.items():
            if seq > current.get(p, 0):
                current[p] = seq

    def _stable_clock(self) -> Dict[ProcessId, int]:
        if len(self.all_but_me) != self.n - 1:
            return {p: 0 for p in self.ids}
        stable = self.clock_frontier()
        for clock in self.all_but_me.values():
            for p in stable:
                stable[p] = min(stable[p], clock.get(p, 0))
        return stable

    def stable(self) -> List[Tuple[ProcessId, int, int]]:
        """gc/clock.rs:76-120."""
        new_stable = self._stable_clock()
        out = []
        for p, previous in self.previous_stable.items():
            start, end = previous + 1, new_stable[p]
            # never go backwards (reordered messages)
            new_stable[p] = max(new_stable[p], previous)
            if start <= end:
                out.append((p, start, end))
        self.previous_stable = new_stable
        return out


class Protocol(ABC):
    """protocol/mod.rs:41-115: the single interface implemented by every
    protocol; drivers (oracle simulator, and conceptually the device
    engine) only speak this interface."""

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        self.to_processes_buf: List = []
        self.to_executors_buf: List = []

    # -- identity ------------------------------------------------------
    @abstractmethod
    def id(self) -> ProcessId: ...

    @abstractmethod
    def shard_id(self) -> ShardId: ...

    # -- lifecycle -----------------------------------------------------
    def periodic_events(self) -> List[Tuple[object, int]]:
        """(event, interval_ms) pairs to schedule at start (the second
        element of the reference's ``Protocol::new`` return)."""
        return []

    @staticmethod
    def event_worker(event) -> str:
        """Worker kind (``Message.WORKER`` vocabulary) a periodic event
        routes to under workers > 1 — the ``PeriodicEventIndex`` analog.
        Defaults to the GC worker; protocols with other periodic roles
        (Tempo's clock bump, FPaxos's acceptor GC) override."""
        return "gc"

    @abstractmethod
    def discover(
        self, processes: Sequence[Tuple[ProcessId, ShardId]]
    ) -> Tuple[bool, Dict[ShardId, ProcessId]]: ...

    @abstractmethod
    def submit(self, dot: Optional[Dot], cmd: Command, time: SysTime) -> None: ...

    @abstractmethod
    def handle(
        self,
        from_: ProcessId,
        from_shard_id: ShardId,
        msg: Message,
        time: SysTime,
    ) -> None: ...

    def handle_event(self, event: object, time: SysTime) -> None:
        pass

    def handle_executed(self, committed_and_executed, time: SysTime) -> None:
        """Periodic executed notification from the executor
        (mod.rs:97-104); only Caesar uses it."""

    # -- outboxes (pull-style, like to_processes/to_executors) ---------
    def to_processes(self) -> List:
        out, self.to_processes_buf = self.to_processes_buf, []
        return out

    def to_executors(self) -> List:
        out, self.to_executors_buf = self.to_executors_buf, []
        return out

    # -- static capabilities -------------------------------------------
    @staticmethod
    def parallel() -> bool:
        """Whether intra-process protocol state supports multiple workers."""
        return False

    @staticmethod
    def leaderless() -> bool:
        return True

    @abstractmethod
    def metrics(self) -> ProtocolMetrics: ...
