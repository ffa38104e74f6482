"""The step's frozen-lane contract against a reference trajectory.

A step under its cap (``frozen_step``) writes every plane of a lane its
run predicate freezes as it was, and K2 (``land_emissions``) reports the
predicate as ``running``: no select follows the step. The step tests
hold that to the reference: from a batch's initial state with every
third lane failed (``ERR_STUCK``), each of the trajectory's steps of
``frozen_step`` must give

- ``running`` equal to the reference's ``_lane_running`` on the state
  the step started from;
- the whole state equal, lane for lane, to the reference's
  ``_lane_step`` trajectory (``jax.vmap`` of the unfrozen batch) on the
  lanes that ran, and to the state before the step on the others.

All comparisons are exact (integer and bool state)."""

import jax
import numpy as np

from fantoch_tpu.engine.core import _lane_running
from fantoch_tpu.engine.faults import FaultFlags as RFlags
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.core import frozen_step
from fantoch_tpu_torch.engine.dims import ERR_STUCK
from fantoch_tpu_torch.engine.faults import FaultFlags

MAX_STEPS = 1 << 22


def _where(mask, new, old):
    """Per-lane select over two numpy trees: ``new`` where ``mask``."""
    if isinstance(new, dict):
        return {k: _where(mask, new[k], old[k]) for k in new}
    new, old = np.asarray(new), np.asarray(old)
    return np.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new,
                    old)


def _assert_equal(want, got, path=""):
    assert sorted(want) == sorted(got), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_equal(want[k], got[k], f"{path}/{k}")
            continue
        a, b = np.asarray(want[k]), got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, f"{path}/{k}"
        if not np.array_equal(a, b):
            bad = np.argwhere(a != b)[:5].tolist()
            raise AssertionError(f"{path}/{k} differs at {bad}")


def failed_third(state):
    """``state`` (numpy) with every third lane's error word set."""
    err = np.asarray(state["err"]).copy()
    err[::3] |= ERR_STUCK
    return dict(state, err=err)


def frozen_steps_match(port, dims, state, ctx, ref_states, reorder=False,
                       faults=(False,) * 5, monitor_keys=0):
    """``len(ref_states)`` ``frozen_step``s of the port from ``state``
    (the reference batch's initial state, numpy) with every third lane
    failed, against the reference's unfrozen trajectory ``ref_states``
    (the states after each of its ``_lane_step``s) and its
    ``_lane_running``; ``faults`` is the batch's flag tuple and
    ``ctx`` numpy. Returns the lanes that ran the last step."""
    start = failed_third(state)
    predicate = jax.jit(jax.vmap(lambda s, c: _lane_running(
        None, s, c, MAX_STEPS, RFlags(*faults))))
    want = start
    st, pctx = carry.to_torch(start, "cpu"), carry.to_torch(ctx, "cpu")
    for i, ref in enumerate(ref_states):
        run = np.asarray(predicate(want, ctx))
        st, running = frozen_step(port, dims, st, pctx, MAX_STEPS, reorder,
                                  FaultFlags(*faults), monitor_keys)
        np.testing.assert_array_equal(running.numpy(), run,
                                      err_msg=f"running, step {i + 1}")
        want = _where(run, ref, want)
        try:
            _assert_equal(want, carry.to_numpy(st))
        except AssertionError as e:
            raise AssertionError(f"step {i + 1}: {e}") from None
    assert not run[::3].any(), run
    assert run.any() or run.size == 1, run  # a one-lane batch: all failed
    return run
