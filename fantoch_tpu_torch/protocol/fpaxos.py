"""FPaxos: leader-based Multi-Paxos with flexible quorums.

Capability parity with ``fantoch_ps/src/protocol/fpaxos.rs``: the leader,
per-slot commanders and acceptors are folded into one process via
``MultiSynod`` (fpaxos.rs:16-23); a submit at a non-leader forwards to the
leader (fpaxos.rs:167-196); the leader self-forwards ``MSpawnCommander``
(enabling parallel commanders, fpaxos.rs:198-238); accepts go to the f+1
write quorum; chosen slots are broadcast and executed in slot order by the
``SlotExecutor``; stable slots are GC'd via committed-frontier exchange
(fpaxos.rs:343-378, synod/gc.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.command import Command
from ..core.config import Config
from ..core.ids import Dot, ProcessId, ShardId
from ..core.timing import SysTime
from ..executor.slot import SlotExecutionInfo, SlotExecutor
from .base import BaseProcess, Message, Protocol, ToForward, ToSend
from .synod import (
    ACCEPT,
    ACCEPTED,
    CHOSEN,
    FORWARD_SUBMIT,
    SPAWN_COMMANDER,
    MultiSynod,
    SynodGCTrack,
)


# messages (fpaxos.rs:382-408)
@dataclass
class MForwardSubmit(Message):
    WORKER = "leader"  # fpaxos.rs:383-453 routing

    cmd: Command


@dataclass
class MSpawnCommander(Message):
    WORKER = "slot"

    ballot: int
    slot: int
    cmd: Command


@dataclass
class MAccept(Message):
    WORKER = "aux"  # ACCEPTOR_WORKER_INDEX

    ballot: int
    slot: int
    cmd: Command


@dataclass
class MAccepted(Message):
    WORKER = "slot"  # back to the spawned commander

    ballot: int
    slot: int


@dataclass
class MChosen(Message):
    WORKER = "aux"

    slot: int
    cmd: Command


@dataclass
class MGarbageCollection(Message):
    WORKER = "aux"  # the acceptor holds the slots to gc

    committed: int


GARBAGE_COLLECTION = "garbage_collection"


class FPaxos(Protocol):
    EXECUTOR = SlotExecutor

    def __init__(self, process_id: ProcessId, shard_id: ShardId, config: Config):
        super().__init__(process_id, shard_id, config)
        fast_quorum_size = 0  # no fast paths (fpaxos.rs:37)
        write_quorum_size = config.fpaxos_quorum_size()
        self.bp = BaseProcess(
            process_id, shard_id, config, fast_quorum_size, write_quorum_size
        )
        assert config.leader is not None, (
            "in a leader-based protocol, the initial leader should be defined"
        )
        self.leader = config.leader
        self.multi_synod: MultiSynod[Command] = MultiSynod(
            process_id, self.leader, config.n, config.f
        )
        self.gc_track = SynodGCTrack(process_id, config.n)

    def periodic_events(self):
        if self.bp.config.gc_interval_ms is not None:
            return [(GARBAGE_COLLECTION, self.bp.config.gc_interval_ms)]
        return []

    def id(self) -> ProcessId:
        return self.bp.process_id

    def shard_id(self) -> ShardId:
        return self.bp.shard_id

    def discover(self, processes):
        ok = self.bp.discover(processes)
        return ok, self.bp.closest_shard_process()

    def submit(self, dot: Optional[Dot], cmd: Command, time: SysTime) -> None:
        self._handle_submit(cmd)

    def handle(self, from_, from_shard_id, msg, time) -> None:
        if isinstance(msg, MForwardSubmit):
            self._handle_submit(msg.cmd)
        elif isinstance(msg, MSpawnCommander):
            self._handle_mspawn_commander(from_, msg)
        elif isinstance(msg, MAccept):
            self._handle_maccept(from_, msg)
        elif isinstance(msg, MAccepted):
            self._handle_maccepted(from_, msg)
        elif isinstance(msg, MChosen):
            self._handle_mchosen(msg)
        elif isinstance(msg, MGarbageCollection):
            self._handle_mgc(from_, msg)
        else:
            raise TypeError(f"unexpected message {msg!r}")

    def handle_event(self, event, time) -> None:
        assert event == GARBAGE_COLLECTION
        self.to_processes_buf.append(
            ToSend(
                target=self.bp.all_but_me(),
                msg=MGarbageCollection(self.gc_track.committed()),
            )
        )

    @staticmethod
    def event_worker(event) -> str:
        # the acceptor worker holds the slots to gc (fpaxos.rs routing)
        return "aux"

    @staticmethod
    def parallel() -> bool:
        return True

    @staticmethod
    def leaderless() -> bool:
        return False

    def metrics(self):
        return self.bp.metrics

    # -- handlers (fpaxos.rs:165-378) -----------------------------------

    def _handle_submit(self, cmd: Command) -> None:
        out = self.multi_synod.submit(cmd)
        if out[0] == SPAWN_COMMANDER:
            _, ballot, slot, cmd = out
            self.to_processes_buf.append(
                ToForward(MSpawnCommander(ballot, slot, cmd))
            )
        elif out[0] == FORWARD_SUBMIT:
            self.to_processes_buf.append(
                ToSend(target={self.leader}, msg=MForwardSubmit(out[1]))
            )
        else:
            raise AssertionError(out)

    def _handle_mspawn_commander(self, from_, msg: MSpawnCommander) -> None:
        assert from_ == self.id()
        out = self.multi_synod.handle_spawn_commander(
            msg.ballot, msg.slot, msg.cmd
        )
        assert out[0] == ACCEPT
        _, ballot, slot, cmd = out
        self.to_processes_buf.append(
            ToSend(
                target=self.bp.write_quorum(), msg=MAccept(ballot, slot, cmd)
            )
        )

    def _handle_maccept(self, from_, msg: MAccept) -> None:
        out = self.multi_synod.handle_accept(msg.ballot, msg.slot, msg.cmd)
        if out is not None:
            _, ballot, slot = out
            self.to_processes_buf.append(
                ToSend(target={from_}, msg=MAccepted(ballot, slot))
            )

    def _handle_maccepted(self, from_, msg: MAccepted) -> None:
        out = self.multi_synod.handle_accepted(from_, msg.ballot, msg.slot)
        if out is not None:
            _, slot, cmd = out
            self.to_processes_buf.append(
                ToSend(target=self.bp.all(), msg=MChosen(slot, cmd))
            )

    def _handle_mchosen(self, msg: MChosen) -> None:
        self.to_executors_buf.append(SlotExecutionInfo(msg.slot, msg.cmd))
        if self._gc_running():
            self.gc_track.commit(msg.slot)
        else:
            self.multi_synod.gc_single(msg.slot)

    def _handle_mgc(self, from_, msg: MGarbageCollection) -> None:
        self.gc_track.committed_by(from_, msg.committed)
        stable = self.gc_track.stable()
        stable_count = self.multi_synod.gc(stable)
        self.bp.stable(stable_count)

    def _gc_running(self) -> bool:
        return self.bp.config.gc_interval_ms is not None
