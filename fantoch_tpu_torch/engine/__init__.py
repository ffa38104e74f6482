"""The batched device engine: lane construction, the step, the run loop
and result collection."""

from .dims import EngineDims, err_names
from .driver import prepare_batch, run_lanes
from .results import LaneResults, collect_results
from .spec import LaneSpec, make_lane, stack_lanes

__all__ = [
    "EngineDims", "LaneResults", "LaneSpec", "collect_results", "err_names",
    "make_lane", "prepare_batch", "run_lanes", "stack_lanes",
]
