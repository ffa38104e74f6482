"""Synthetic workload generation.

Capability parity with ``fantoch/src/client/workload.rs``: commands with
``keys_per_command`` unique keys, a read-only percentage, a payload, and a
per-client command budget (workload.rs:12-212). The target shard is the
shard of the first generated key (workload.rs:156-186); key→shard mapping is
``key_hash % shard_count`` (workload.rs:209-211).
"""

from __future__ import annotations

import random
import string
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.command import Command
from ..core.ids import RiflGen, ShardId
from ..core.kvs import GET, PUT, Key
from ..core.util import key_hash
from .key_gen import ConflictPool, KeyGen, KeyGenState, true_if_random_is_less_than


@dataclass
class Workload:
    shard_count: int
    key_gen: KeyGen
    keys_per_command: int
    commands_per_client: int
    payload_size: int
    read_only_percentage: int = 0
    command_count: int = 0

    def __post_init__(self) -> None:
        # valid-workload checks (workload.rs:38-55)
        if isinstance(self.key_gen, ConflictPool):
            assert self.key_gen.conflict_rate <= 100
            assert self.key_gen.pool_size >= 1
            if self.key_gen.conflict_rate == 100 and self.keys_per_command > 1:
                raise ValueError(
                    "can't generate more than one key when conflict_rate is 100"
                )
            if self.keys_per_command > 2:
                raise ValueError(
                    "can't generate more than two keys with the conflict_rate"
                    " key generator"
                )

    def initial_state(
        self, client_id: int, rng: Optional[random.Random] = None
    ) -> KeyGenState:
        return KeyGenState(self.key_gen, self.shard_count, client_id, rng)

    def issued_commands(self) -> int:
        return self.command_count

    def finished(self) -> bool:
        return self.command_count == self.commands_per_client

    def next_cmd(
        self, rifl_gen: RiflGen, key_gen_state: KeyGenState
    ) -> Optional[Tuple[ShardId, Command]]:
        """workload.rs:113-128."""
        if self.command_count >= self.commands_per_client:
            return None
        self.command_count += 1
        return self.gen_cmd(rifl_gen, key_gen_state)

    def gen_cmd(
        self, rifl_gen: RiflGen, key_gen_state: KeyGenState
    ) -> Tuple[ShardId, Command]:
        """workload.rs:142-186."""
        rifl = rifl_gen.next_id()
        keys = self._gen_unique_keys(key_gen_state)
        # a traffic-scheduled DeviceStream drives the read mix from its
        # per-epoch read_pct via the counter-based stream (bit-exact
        # with the schedule spec); otherwise the workload's own
        # read_only_percentage draw applies (workload.rs:148-150)
        read_only = key_gen_state.traffic_read_only()
        if read_only is None:
            read_only = true_if_random_is_less_than(
                self.read_only_percentage, key_gen_state.rng
            )
        shard_to_ops: Dict[ShardId, Dict[Key, list]] = {}
        target_shard: Optional[ShardId] = None
        for key in keys:
            op = (GET,) if read_only else (PUT, self._gen_value(key_gen_state))
            shard_id = self.shard_id(key)
            shard_to_ops.setdefault(shard_id, {})[key] = [op]
            if target_shard is None:
                target_shard = shard_id
        assert target_shard is not None
        return target_shard, Command(rifl, shard_to_ops)

    def _gen_unique_keys(self, key_gen_state: KeyGenState) -> List[Key]:
        keys: List[Key] = []
        while len(keys) != self.keys_per_command:
            key = key_gen_state.gen_cmd_key()
            if key not in keys:
                keys.append(key)
        return keys

    def _gen_value(self, key_gen_state: KeyGenState) -> str:
        if self.payload_size == 0:
            return ""
        rng = key_gen_state.rng
        return "".join(
            rng.choices(string.ascii_letters + string.digits,
                        k=self.payload_size)
        )

    def shard_id(self, key: Key) -> ShardId:
        return key_hash(key) % self.shard_count
