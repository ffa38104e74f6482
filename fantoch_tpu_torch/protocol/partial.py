"""Partial-replication (multi-shard) coordination helpers.

Capability parity with ``fantoch_ps/src/protocol/partial.rs``, shared by
Tempo and Atlas: forward a submit to the closest process of each other
shard touched by the command (partial.rs:8-35), and aggregate per-shard
commit data at the dot-owner process before the final ``MCommit``
(partial.rs:37-203).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Generic, Optional, Set, TypeVar

from ..core.command import Command
from ..core.ids import Dot, ProcessId
from .base import BaseProcess, ToSend

I = TypeVar("I")


def submit_actions(
    bp: BaseProcess,
    dot: Dot,
    cmd: Command,
    target_shard: bool,
    create_mforward_submit,
    to_processes: list,
) -> None:
    """partial.rs:8-35."""
    if not target_shard:
        return
    for shard_id in cmd.shards():
        if shard_id != bp.shard_id:
            to_processes.append(
                ToSend(
                    target={bp.closest_process(shard_id)},
                    msg=create_mforward_submit(dot, cmd),
                )
            )


@dataclass
class ShardsCommits(Generic[I]):
    """partial.rs:205-246."""

    process_id: ProcessId
    shard_count: int
    info: I
    participants: Set[ProcessId] = field(default_factory=set)

    def add(self, from_: ProcessId, add) -> bool:
        assert from_ not in self.participants
        self.participants.add(from_)
        add(self.info)
        return len(self.participants) == self.shard_count

    def update(self, update) -> None:
        update(self.info)


def _init_shards_commits(holder, bp: BaseProcess, shard_count: int, default):
    """``holder`` is the per-dot info record; its ``shards_commits`` field
    is created lazily (partial.rs:187-203)."""
    if holder.shards_commits is None:
        holder.shards_commits = ShardsCommits(
            bp.process_id, shard_count, default()
        )
    return holder.shards_commits


def mcommit_actions(
    bp: BaseProcess,
    holder,
    shard_count: int,
    dot: Dot,
    data1,
    data2,
    create_mcommit,
    create_mshard_commit,
    update_shards_commits_info,
    to_processes: list,
    default_info,
) -> None:
    """partial.rs:37-101."""
    if shard_count == 1:
        to_processes.append(
            ToSend(target=bp.all(), msg=create_mcommit(dot, data1, data2))
        )
        return
    shards_commits = _init_shards_commits(holder, bp, shard_count, default_info)
    shards_commits.update(
        lambda info: update_shards_commits_info(info, data2)
    )
    # aggregate at the dot-owner process (the client-targetted shard)
    to_processes.append(
        ToSend(target={dot.source}, msg=create_mshard_commit(dot, data1))
    )


def handle_mshard_commit(
    bp: BaseProcess,
    holder,
    shard_count: int,
    from_: ProcessId,
    dot: Dot,
    data,
    add_shards_commits_info,
    create_mshard_aggregated_commit,
    to_processes: list,
    default_info,
) -> None:
    """partial.rs:103-142."""
    shards_commits = _init_shards_commits(holder, bp, shard_count, default_info)
    done = shards_commits.add(
        from_, lambda info: add_shards_commits_info(info, data)
    )
    if done:
        to_processes.append(
            ToSend(
                target=set(shards_commits.participants),
                msg=create_mshard_aggregated_commit(dot, shards_commits.info),
            )
        )


def handle_mshard_aggregated_commit(
    bp: BaseProcess,
    holder,
    dot: Dot,
    data1,
    extract_mcommit_extra_data,
    create_mcommit,
    to_processes: list,
) -> None:
    """partial.rs:144-167."""
    shards_commits = holder.shards_commits
    assert shards_commits is not None, (
        f"no shards commit info when handling MShardAggregatedCommit {dot}"
    )
    holder.shards_commits = None
    data2 = extract_mcommit_extra_data(shards_commits.info)
    to_processes.append(
        ToSend(target=bp.all(), msg=create_mcommit(dot, data1, data2))
    )
