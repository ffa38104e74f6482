"""Paxos engines: single-decree ``Synod`` and multi-decree ``MultiSynod``.

Capability parity with ``fantoch_ps/src/protocol/common/synod/``:

- ``Synod`` (single.rs:11-130): single-decree Flexible Paxos used for the
  slow path of Tempo/Atlas/EPaxos; supports ``skip_prepare`` since the
  initial coordinator owns its ballot.
- ``MultiSynod`` (multi.rs:18-306): multi-decree engine for FPaxos, folding
  leader + per-slot commanders + acceptor roles into one process; phase-2
  waits for f+1 accepts.
- ``SynodGCTrack`` (gc.rs): slot-stability tracking (min committed frontier
  across processes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Generic, Optional, Set, Tuple, TypeVar

from ..core.ids import ProcessId

V = TypeVar("V")
Ballot = int
Slot = int


# ---------------------------------------------------------------------------
# single-decree synod (single.rs)
# ---------------------------------------------------------------------------


# Synod message kinds (single.rs:11-20); messages are tagged tuples:
#   (S_CHOSEN, value) | (S_PREPARE, b) | (S_ACCEPT, b, value)
#   | (S_PROMISE, b, (accepted_ballot, accepted_value)) | (S_ACCEPTED, b)
S_CHOSEN = "chosen"
S_PREPARE = "prepare"
S_ACCEPT = "accept"
S_PROMISE = "promise"
S_ACCEPTED = "accepted"


class Synod(Generic[V]):
    """Single-decree Flexible Paxos (single.rs:22-137).

    Phase-1 waits n-f promises; phase-2 waits f+1 accepts.
    ``skip_prepare`` generates the first ballot (= the coordinator's
    process id) without a prepare phase — safe because any prepared ballot
    is > n (single.rs:83-89).
    """

    def __init__(
        self,
        process_id: ProcessId,
        n: int,
        f: int,
        proposal_gen,
        initial_value: V,
    ):
        self.process_id = process_id
        self.n = n
        self.f = f
        self.proposal_gen = proposal_gen
        # acceptor state (single.rs:365-375)
        self.acc_ballot: Ballot = 0
        self.acc_accepted: Tuple[Ballot, V] = (0, initial_value)
        # proposer state (single.rs:142-163)
        self.prop_ballot: Ballot = 0
        self.promises: Dict[ProcessId, Tuple[Ballot, V]] = {}
        self.accepts: Set[ProcessId] = set()
        self.proposal: Optional[V] = None
        self.chosen = False

    # -- public API (single.rs:30-137) ---------------------------------

    def set_if_not_accepted(self, value_gen) -> bool:
        if self.acc_ballot == 0:
            self.acc_accepted = (0, value_gen())
            return True
        return False

    def value(self) -> V:
        return self.acc_accepted[1]

    def new_prepare(self):
        assert self.acc_ballot >= self.prop_ballot
        round_ = self.acc_ballot // self.n
        self.prop_ballot = self.process_id + self.n * (round_ + 1)
        self.promises = {}
        self.accepts = set()
        self.proposal = None
        return (S_PREPARE, self.prop_ballot)

    def skip_prepare(self) -> Ballot:
        assert self.acc_ballot == 0
        self.prop_ballot = self.process_id
        return self.prop_ballot

    def handle(self, from_: ProcessId, msg):
        kind = msg[0]
        if kind == S_CHOSEN:
            self.chosen = True
            self.acc_accepted = (0, msg[1])
            return None
        if kind == S_PREPARE:
            return self._chosen() or self._acc_handle_prepare(msg[1])
        if kind == S_ACCEPT:
            return self._chosen() or self._acc_handle_accept(msg[1], msg[2])
        if kind == S_PROMISE:
            return self._prop_handle_promise(from_, msg[1], msg[2])
        if kind == S_ACCEPTED:
            return self._prop_handle_accepted(from_, msg[1])
        raise TypeError(f"unexpected synod message {msg!r}")

    def _chosen(self):
        if self.chosen:
            return (S_CHOSEN, self.value())
        return None

    # -- acceptor (single.rs:377-430) ----------------------------------

    def _acc_handle_prepare(self, b: Ballot):
        if b > self.acc_ballot:
            self.acc_ballot = b
            return (S_PROMISE, b, self.acc_accepted)
        return None

    def _acc_handle_accept(self, b: Ballot, value: V):
        if b >= self.acc_ballot:
            self.acc_ballot = b
            self.acc_accepted = (b, value)
            return (S_ACCEPTED, b)
        return None

    # -- proposer (single.rs:246-358) ----------------------------------

    def _prop_handle_promise(self, from_, b: Ballot, accepted):
        if self.prop_ballot != b:
            return None
        self.promises[from_] = accepted
        if len(self.promises) != self.n - self.f:
            return None
        promises, self.promises = self.promises, {}
        self.accepts = set()
        highest_ballot, highest_from = max(
            ((ballot, pid) for pid, (ballot, _v) in promises.items()),
        )
        if highest_ballot == 0:
            values = {pid: v for pid, (_b, v) in promises.items()}
            proposal = self.proposal_gen(values)
        else:
            proposal = promises[highest_from][1]
        self.proposal = proposal
        return (S_ACCEPT, b, proposal)

    def _prop_handle_accepted(self, from_, b: Ballot):
        if self.prop_ballot != b:
            return None
        self.accepts.add(from_)
        if len(self.accepts) != self.f + 1:
            return None
        proposal, self.proposal = self.proposal, None
        self.promises = {}
        self.accepts = set()
        if proposal is None:
            # still at the first (skip-prepare) ballot: the value is the one
            # our own acceptor accepted (single.rs:336-350)
            acc_ballot, acc_value = self.acc_accepted
            assert acc_ballot == self.process_id, (
                "there should have been a proposal before a value is chosen"
            )
            proposal = acc_value
        return (S_CHOSEN, proposal)


# ---------------------------------------------------------------------------
# multi-decree synod (multi.rs)
# ---------------------------------------------------------------------------


@dataclass
class _Leader:
    """multi.rs:169-210."""

    process_id: ProcessId
    is_leader: bool
    ballot: Ballot
    last_slot: Slot = 0

    def try_submit(self) -> Optional[Tuple[Ballot, Slot]]:
        if not self.is_leader:
            return None
        self.last_slot += 1
        return self.ballot, self.last_slot


@dataclass
class _Commander(Generic[V]):
    """Watches accepts for one slot (multi.rs:212-259)."""

    f: int
    ballot: Ballot
    value: V
    accepts: Set[ProcessId] = field(default_factory=set)

    def handle_accepted(self, from_: ProcessId, ballot: Ballot) -> bool:
        if self.ballot != ballot:
            return False
        self.accepts.add(from_)
        return len(self.accepts) == self.f + 1


class _Acceptor(Generic[V]):
    """multi.rs:261-320: joins the initial leader's ballot at bootstrap."""

    def __init__(self, initial_leader: ProcessId):
        self.ballot: Ballot = initial_leader
        self.accepted: Dict[Slot, Tuple[Ballot, V]] = {}

    def handle_accept(self, b: Ballot, slot: Slot, value: V) -> bool:
        if b >= self.ballot:
            self.ballot = b
            self.accepted[slot] = (b, value)
            return True
        return False

    def gc(self, stable: Tuple[int, int]) -> int:
        start, end = stable
        count = 0
        for slot in range(start, end + 1):
            if self.accepted.pop(slot, None) is not None:
                count += 1
        return count

    def gc_single(self, slot: Slot) -> None:
        self.accepted.pop(slot, None)


# outputs of MultiSynod.submit/handle — tagged tuples mirroring
# MultiSynodMessage (multi.rs:18-31)
SPAWN_COMMANDER = "spawn_commander"
FORWARD_SUBMIT = "forward_submit"
ACCEPT = "accept"
ACCEPTED = "accepted"
CHOSEN = "chosen"


class MultiSynod(Generic[V]):
    """multi.rs:33-166."""

    def __init__(
        self, process_id: ProcessId, initial_leader: ProcessId, n: int, f: int
    ):
        self.n = n
        self.f = f
        self.leader = _Leader(
            process_id,
            is_leader=(process_id == initial_leader),
            ballot=initial_leader if process_id == initial_leader else 0,
        )
        self.acceptor: _Acceptor[V] = _Acceptor(initial_leader)
        self.commanders: Dict[Slot, _Commander[V]] = {}

    def submit(self, value: V):
        res = self.leader.try_submit()
        if res is not None:
            ballot, slot = res
            return (SPAWN_COMMANDER, ballot, slot, value)
        return (FORWARD_SUBMIT, value)

    def handle_spawn_commander(self, ballot: Ballot, slot: Slot, value: V):
        assert slot not in self.commanders
        self.commanders[slot] = _Commander(self.f, ballot, value)
        return (ACCEPT, ballot, slot, value)

    def handle_accept(self, ballot: Ballot, slot: Slot, value: V):
        if self.acceptor.handle_accept(ballot, slot, value):
            return (ACCEPTED, ballot, slot)
        return None

    def handle_accepted(self, from_: ProcessId, ballot: Ballot, slot: Slot):
        commander = self.commanders.get(slot)
        if commander is None:
            return None
        if commander.handle_accepted(from_, ballot):
            value = self.commanders.pop(slot).value
            return (CHOSEN, slot, value)
        return None

    def gc(self, stable: Tuple[int, int]) -> int:
        return self.acceptor.gc(stable)

    def gc_single(self, slot: Slot) -> None:
        self.acceptor.gc_single(slot)


class SynodGCTrack:
    """Slot-stability tracking for FPaxos (synod/gc.rs:7-77)."""

    def __init__(self, process_id: ProcessId, n: int):
        from ..protocol.base import AEClockSet

        self.process_id = process_id
        self.n = n
        self.committed_set = AEClockSet()
        self.all_but_me: Dict[ProcessId, int] = {}
        self.previous_stable = 0

    def commit(self, slot: Slot) -> None:
        self.committed_set.add(slot)

    def committed(self) -> int:
        return self.committed_set.frontier

    def committed_by(self, from_: ProcessId, committed: int) -> None:
        self.all_but_me[from_] = committed

    def _stable_slot(self) -> int:
        if len(self.all_but_me) != self.n - 1:
            return 0
        return min(
            [self.committed_set.frontier, *self.all_but_me.values()]
        )

    def stable(self) -> Tuple[int, int]:
        new_stable = self._stable_slot()
        slot_range = (self.previous_stable + 1, new_stable)
        self.previous_stable = new_stable
        return slot_range
