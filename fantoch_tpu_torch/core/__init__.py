"""Host foundation: ids, config, planet and the exact histogram."""

from .config import Config
from .ids import ClientId, ProcessId, ShardId
from .metrics import Histogram
from .planet import Planet, Region

__all__ = [
    "ClientId", "Config", "Histogram", "Planet", "ProcessId", "Region",
    "ShardId",
]
