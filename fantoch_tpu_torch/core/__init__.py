"""Host foundation: ids, commands, the KV store, config, time, planet
and metrics — what lane construction and the host oracle share."""

from .command import (
    DEFAULT_SHARD_ID, Command, CommandResult, CommandResultBuilder,
)
from .config import Config
from .ids import (
    ClientId, Dot, DotGen, Id, IdGen, ProcessId, Rifl, RiflGen, ShardId,
    all_process_ids, dots, process_ids,
)
from .kvs import DELETE, GET, PUT, ExecutionOrderMonitor, Key, KVStore, Value
from .metrics import Histogram, Metrics
from .planet import Planet, Region
from .timing import RunTime, SimTime, SysTime
from .util import closest_process_per_shard, key_hash, sort_processes_by_distance

__all__ = [
    "ClientId", "Command", "CommandResult", "CommandResultBuilder",
    "Config", "DEFAULT_SHARD_ID", "DELETE", "Dot", "DotGen",
    "ExecutionOrderMonitor", "GET", "Histogram", "Id", "IdGen", "KVStore",
    "Key", "Metrics", "PUT", "Planet", "ProcessId", "Region", "Rifl",
    "RiflGen", "RunTime", "ShardId", "SimTime", "SysTime", "Value",
    "all_process_ids", "closest_process_per_shard", "dots", "key_hash",
    "process_ids", "sort_processes_by_distance",
]
