"""A short run of a main path for a memory or race checker on the card.

    compute-sanitizer --tool memcheck \\
        python -m fantoch_tpu_torch.sanitize --protocol atlas
    compute-sanitizer --tool racecheck \\
        python -m fantoch_tpu_torch.sanitize --protocol atlas --eager \\
        --steps 3

The first ``--lanes`` lanes of the protocol's main-path batch
(``cli.MAIN_PATHS``) run ``--steps`` steps under the batch's reorder
flag and fault-flag union: by default in one window of the device loop
(``engine.core.build_segment_runner``, the graph the sweeps run), with
``--eager`` through the wrappers, one launch of each kernel a step
(``engine.core.frozen_step``). No profiler runs. Prints one JSON line:
the steps each lane ran and its error word.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import cli
from .engine.core import build_segment_runner, frozen_step
from .engine.driver import batch_reorder_flag, prepare_batch
from .engine.faults import batch_fault_flags


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--protocol", default="atlas")
    p.add_argument("--lanes", type=int, default=8)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--eager", action="store_true")
    args = p.parse_args(argv)
    sweep = cli.parse_args(cli.MAIN_PATHS[args.protocol])
    protocol, dims, specs = cli.sweep_setup(sweep)
    batch = specs[:args.lanes]
    reorder, faults = batch_reorder_flag(batch), batch_fault_flags(batch)
    state, ctx = prepare_batch(protocol, dims, batch, torch.device("cuda"))
    if args.eager:
        for _ in range(args.steps):
            state, _running = frozen_step(protocol, dims, state, ctx,
                                          1 << 22, reorder, faults)
    else:
        runner, _alive = build_segment_runner(protocol, dims, 1 << 22,
                                              reorder, faults)
        state, _any = runner(state, ctx, args.steps)
    torch.cuda.synchronize()
    print(json.dumps({"protocol": args.protocol, "eager": args.eager,
                      "steps": state["steps"].tolist(),
                      "err": state["err"].tolist()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
