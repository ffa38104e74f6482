"""The port-side double-reply wrapper of the open-loop checks
(``tests/test_torch_open_loop_step.py`` and ``chip_smoke.py``); it
imports torch only."""

import torch


class PortDoubleReply:
    """A port protocol's handlers with each result row also copied into
    the handler outbox's last slot when that is free, on ``[L, N, F]``
    outboxes, so that a client completes two commands in one step (no
    protocol's handler emits two results a call): the open-loop client's
    count-based attribution for that case."""

    def __init__(self, base):
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)

    def handlers(self, ps, has, rows, fire, ep, ctx, dims, cap=None):
        rdy, ps, pout, ob = self._base.handlers(ps, has, rows, fire, ep,
                                                ctx, dims, cap)
        is_tc = ob["valid"] & (ob["dst"] >= dims.N)
        i = is_tc.to(torch.int32).argmax(-1)
        j = ob["valid"].shape[-1] - 1
        dup = is_tc.any(-1) & ~ob["valid"][..., j] & (i != j)
        lanes = torch.arange(i.shape[0], device=i.device)[:, None]
        procs = torch.arange(i.shape[1], device=i.device)[None, :]
        out = {}
        for k, v in ob.items():
            v = v.clone()
            m = dup.reshape(dup.shape + (1,) * (v.dim() - 3))
            v[:, :, j] = torch.where(m, v[lanes, procs, i], v[:, :, j])
            out[k] = v
        return rdy, ps, pout, out
