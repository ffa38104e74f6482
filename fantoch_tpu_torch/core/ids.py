"""Identifier types (the reference's ``fantoch/src/id.rs`` aliases).

The device engine allocates dot sequence numbers with on-device counters,
so only the integer aliases the host code names are kept.
"""

ProcessId = int
ClientId = int
ShardId = int
