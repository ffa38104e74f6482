"""The step's tail and the run loop's predicate: the plain twins of
``emit_rewrite`` (K6) and ``land_emissions`` (K2) against the
reference's own code on seeded random inputs (numpy).

- ``emit_rewrite``: the reference's whole ``_lane_step`` runs with a
  stub protocol whose gate, timers and handlers return given tables
  (readiness, both outboxes, new error words); the port runs
  ``qualify_pop``, ``emit_rewrite`` and ``land_emissions`` (their twins)
  on the same pool and tables. Every plane of the new state must be
  equal. The tables reach what one run's trajectory may not: clients
  past the table, requeues, several results for one client, padded
  clients and region rows, histogram buckets past the last.
- ``land_emissions``' ``running``: ``_lane_running`` (core.py:1565),
  which the vmapped while loop's per-lane select (:1591) reads, against
  the predicate K2's twin reports under the step's cap, with lanes
  frozen for each reason; a frozen lane keeps K2's planes as they
  were."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fantoch_tpu.engine import EngineDims as RDims
from fantoch_tpu.engine.core import _lane_running, _lane_step
from fantoch_tpu_torch import carry
from fantoch_tpu_torch.engine.dims import (
    INF, PA, PDST, PKC, PKS, PPR, PRQ, EngineDims,
)
from fantoch_tpu_torch.kernels import (
    emit_rewrite, land_emissions, qualify_pop,
)

SEEDS = [0, 1, 2, 3]
L, N, C, F, P, M, R, RR, H, T, LOG = 16, 4, 5, 5, 3, 48, 1, 3, 12, 6, 64
W = 8 + P


class Stub:
    """A protocol whose handlers return the tables its state carries:
    ``rdy [N]``, the outboxes ``p*``/``h* [N, F]`` and the new error
    words ``perr [N]``."""

    SUBMIT = 0
    NUM_TYPES = 3

    @staticmethod
    def ready(ps, msg, me, ctx, dims):
        return ps["rdy"]

    @staticmethod
    def periodic(ps, fire, me, now, ctx, dims):
        return ps, _outbox(ps, "p")

    @staticmethod
    def handle(ps, msg, me, now, ctx, dims):
        return dict(ps, err=ps["perr"]), _outbox(ps, "h")

    @staticmethod
    def error(ps):
        return ps["err"]


def _outbox(ps, side):
    f = ps[side + "v"].shape[0]
    return {
        "valid": ps[side + "v"],
        "dst": ps[side + "d"],
        "mtype": ps[side + "m"],
        "payload": ps[side + "p"],
        "delay": jnp.full((f,), -1, jnp.int32),
        "src": jnp.full((f,), -1, jnp.int32),
    }


def _inputs(seed):
    rng = np.random.default_rng(seed)
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (L, *s)).astype(np.int32)  # noqa: E731
    rb = lambda p, *s: rng.random((L, *s)) < p  # noqa: E731
    pool = ri(0, 9, M, W)
    pool[..., PA] = np.where(rb(0.5, M), INF, ri(0, 5, M))
    pool[..., PKS] = ri(0, N + C, M)
    pool[..., PKC] = ri(0, 4, M)
    pool[..., PDST] = ri(0, N, M)
    pool[..., PPR] = rb(0.2, M)
    pool[..., PRQ] = ri(0, 3, M)
    pool[0, :, PA] = INF                     # an idle lane
    pool[1, :-2, PA] = 2                     # a nearly full pool
    budget = ri(0, 5, C)
    budget[:, 0] = 3
    issued = np.minimum(ri(0, 5, C), budget)
    ps = {"rdy": rb(0.8, N), "perr": ri(0, 2, N) * 8 + ri(0, 2, N) * 256,
          "err": np.zeros((L, N), np.int32)}
    for side in "ph":
        ps[side + "v"] = rb(0.5, N, F)
        # process destinations, clients (some past C) and their mix
        ps[side + "d"] = np.where(rb(0.5, N, F), ri(0, N, N, F),
                                  N + ri(0, C + 2, N, F))
        ps[side + "m"] = ri(0, 3, N, F)
        ps[side + "p"] = ri(0, 9, N, F, P)
    st = {
        "pool": pool,
        "ps": ps,
        "next_periodic": np.where(rb(0.6, N, R), INF, ri(0, 5, N, R)),
        "clients": {
            "issued": issued,
            "completed": ri(0, 3, C),
            "start_time": ri(0, 4, C),
            "parts": np.zeros((L, C), np.int32),
            "part_max": ri(0, 3, C),
        },
        "metrics": {
            "hist": ri(0, 3, RR, H),
            "lat_sum": ri(0, 50, RR),
            "lat_count": ri(0, 5, RR),
            "lat_log": np.where(rb(0.5, C, LOG), -1, ri(0, 20, C, LOG)),
        },
        "now": ri(0, 5),
        "pair_cnt": ri(0, 4, N, N),
        "steps": ri(0, 50),
        "pool_peak": ri(0, M),
        "fault_dropped": np.zeros((L,), np.int32),
        "requeues": ri(0, 3),
        "max_completion": ri(0, 5),
        "done_time": np.where(rb(0.5), INF, ri(0, 5)).astype(np.int32),
        "err": ri(0, 2) * 4,
        "hlog": np.full((L, N, 1, 6), -1, np.int32),
        "hlog_n": np.zeros((L, N), np.int32),
    }
    lookahead = ri(0, 3, N, N)
    lookahead[:, np.arange(N), np.arange(N)] = INF
    ctx = {
        "lookahead": lookahead,
        "periodic_intervals": ri(1, 20, R),
        "client_delay": ri(0, 30, C, N),
        "delay_pp": ri(0, 6, N, N),
        "key_table": ri(0, 7, C, T),
        "cmd_budget": budget,
        "client_attach": ri(0, N, C),
        # padded clients carry the RR row
        "client_region_row": np.where(rb(0.2, C), RR, ri(0, RR, C)),
    }
    return st, ctx


def _dims():
    kw = dict(N=N, C=C, M=M, D=4, F=F, R=R, P=P, H=H, RR=RR)
    return RDims(**kw), EngineDims(**kw)


def _port_step(st, ctx, dims):
    """The port's step around the stub's tables, on the CPU twins."""
    ps = st["ps"]
    arrival, ep, now, _a, fire, _s, has, rows, _t = qualify_pop(
        st["pool"], st["next_periodic"], ctx["lookahead"]
    )

    def outbox(side):
        return {"valid": ps[side + "v"], "dst": ps[side + "d"],
                "mtype": ps[side + "m"], "payload": ps[side + "p"]}

    before = emit_rewrite.launches
    new_rows, valid, upd = emit_rewrite(
        st, ctx, ep, fire, has, ps["rdy"], rows, outbox("p"), outbox("h"),
        ps["perr"], dims, Stub.SUBMIT,
    )
    assert emit_rewrite.launches == before  # the twin, not the kernel
    pool, _o, peak, err, _running = land_emissions(
        st["pool"], arrival, valid, new_rows, st["pool_peak"], upd["err"]
    )
    return {**upd, "pool": pool, "now": now, "pool_peak": peak,
            "err": err}, has, ps["rdy"]


def _partial_inputs(seed, S=2):
    """``_inputs`` with partial replication's tables: a command needs
    1-3 result parts (results arrive in parts already), and its next
    SUBMIT goes to its target shard's connected process."""
    st, ctx = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (L, *s)).astype(np.int32)  # noqa: E731
    st["clients"]["parts"] = ri(0, 3, C)
    ctx["cmd_parts"] = ri(1, 4, C, T - 1)
    ctx["cmd_target"] = ri(0, S, C, T - 1)
    ctx["client_attach_s"] = ri(0, N, C, S)
    return st, ctx


@pytest.mark.parametrize("seed", SEEDS)
def test_emit_rewrite_partial_twin_matches_reference_step(seed):
    """The partial-replication branch (core.py:1177-1182, 1273-1279):
    completion once the command's parts arrived, and the next SUBMIT at
    the target shard's connected process."""
    st, ctx = _partial_inputs(seed)
    want = _check_step(st, ctx)
    issued = want["clients"]["issued"] > st["clients"]["issued"]
    assert issued.any()
    parts = st["clients"]["parts"]
    # results that completed nothing: their count grew short of the need
    assert ((want["clients"]["parts"] > parts) & ~issued).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_emit_rewrite_twin_matches_reference_step(seed):
    st, ctx = _inputs(seed)
    want = _check_step(st, ctx)
    # the inputs reach the paths they are meant to: requeues, a result
    # for a client past the table, a client completing and issuing, the
    # pool overflowing, a protocol error bit past the eight the fold keeps
    # (the requeues: _check_step)
    ps = st["ps"]
    assert any((ps[s + "v"] & (ps[s + "d"] >= N + C)).any() for s in "ph")
    assert (want["clients"]["issued"] > st["clients"]["issued"]).any()
    assert (want["metrics"]["lat_count"] > st["metrics"]["lat_count"]).any()
    assert (want["err"] & 1).any() and not (want["err"] & 256).any()


def _check_step(st, ctx):
    """The reference's step and the port's on the same inputs; asserts
    every plane equal and returns the reference's new state."""
    rdims, dims = _dims()
    want = jax.jit(jax.vmap(lambda s, c: _lane_step(Stub, rdims, s, c)))(
        st, ctx
    )
    want = jax.tree_util.tree_map(np.asarray, want)
    got, has, rdy = _port_step(
        carry.to_torch(st, "cpu"), carry.to_torch(ctx, "cpu"), dims
    )
    got = carry.to_numpy(got)
    for k in got:
        for path, g, w in (
            [(f"{k}/{j}", got[k][j], want[k][j]) for j in got[k]]
            if isinstance(got[k], dict) else [(k, got[k], want[k])]
        ):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(g, w, err_msg=path)
    assert (has.numpy() & ~rdy.numpy()).any()
    return want


def _freeze_inputs(seed):
    rng = np.random.default_rng(seed)
    lanes = 12
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (lanes, *s)).astype(np.int32)  # noqa: E731
    done = np.where(rng.random(lanes) < 0.5, INF, ri(0, 40)).astype(np.int32)
    old = {
        "done_time": done,
        "now": ri(0, 60),
        "err": ri(0, 2) * ri(0, 2) * 8,
        "steps": ri(0, 12),
        "pool": ri(0, 9, 7, W),
        "ps": {"seen": rng.random((lanes, 3, 3)) < 0.5, "x": ri(0, 9, 3)},
        "hlog": ri(0, 9, 2),
    }
    old["now"][0] = INF                       # idle
    old["done_time"][1], old["now"][1] = 5, 40  # finished
    old["done_time"][2], old["now"][2] = 5, 6   # in its extra time
    old["err"][2], old["steps"][2] = 0, 3
    old["err"][3] = 2                         # failed
    old["steps"][4] = 10                      # at max_steps
    new = {
        k: (v if k == "hlog" else jax.tree_util.tree_map(
            lambda a: (a ^ True) if a.dtype == bool else a + 1, v))
        for k, v in old.items()
    }
    ctx = {"extra_time": ri(0, 30)}
    ctx["extra_time"][1], ctx["extra_time"][2] = 10, 10
    return new, old, ctx


def land_under_cap(old, ctx, max_steps, flags=0, seed=0):
    """K2's twin (through its wrapper, on CPU tensors) on a random pool
    and emissions under the cap of ``old`` (``_freeze_inputs``' lane
    words), ``max_steps`` and ``flags``: returns ``(running, pool
    before, capped call's result, uncapped call's result)``, each call
    on its own copy of the pool."""
    from fantoch_tpu_torch.kernels.lane_freeze import Cap

    rng = np.random.default_rng(seed + 100)
    t_old = carry.to_torch(old, "cpu")
    lanes, slots = t_old["pool"].shape[:2]
    pool = t_old["pool"]
    arrival = torch.from_numpy(np.where(
        rng.random((lanes, slots)) < 0.5, INF, 3).astype(np.int32))
    deliver = torch.from_numpy(rng.random((lanes, 4)) < 0.7)
    rows = torch.from_numpy(rng.integers(0, 9, (lanes, 4, W)).astype(np.int32))
    peak = torch.from_numpy(rng.integers(0, slots, lanes).astype(np.int32))
    a = (arrival, deliver, rows, peak, t_old["err"])
    cap = Cap(t_old, carry.to_torch(ctx, "cpu"), max_steps, flags)
    before = land_emissions.launches
    got = land_emissions(pool.clone(), *a, None, None, flags, cap)
    free = land_emissions(pool.clone(), *a, None, None, flags)
    assert land_emissions.launches == before  # the twin, not the kernel
    assert bool(free[4].all())                # no cap: every lane runs
    return got[4], pool, got, free


def assert_frozen_lanes_kept(running, pool, got, free, err):
    """K2 under its cap: a frozen lane's pool rows, peak and error word
    as given and no overflow; a running lane as the uncapped call."""
    run, frozen = running, ~running
    assert torch.equal(got[0][frozen], pool[frozen])
    for g, f in zip(got[:4], free[:4]):
        assert torch.equal(g[run], f[run])
    assert not bool(got[1][frozen].any())
    assert torch.equal(got[3][frozen], err[frozen])
    assert bool((got[0][run] != pool[run]).any())


@pytest.mark.parametrize("seed", SEEDS)
def test_land_emissions_running_matches_reference(seed):
    """K2 reports the run loop's predicate: its ``running`` equals the
    reference's ``_lane_running`` (core.py:1565), with lanes frozen for
    each reason, and a frozen lane's planes are K2's inputs as they
    were (no select after the step)."""
    _new, old, ctx = _freeze_inputs(seed)
    max_steps = 10
    running = jax.vmap(
        lambda s, c: _lane_running(None, s, c, max_steps)
    )(old, ctx)
    got_running, pool, got, free = land_under_cap(old, ctx, max_steps,
                                                  seed=seed)
    np.testing.assert_array_equal(got_running.numpy(), np.asarray(running))
    assert_frozen_lanes_kept(got_running, pool, got, free,
                             torch.from_numpy(old["err"]))
    # idle, finished, failed and cut lanes freeze; one in its extra
    # time runs on
    r = np.asarray(running)
    assert not r[[0, 1, 3, 4]].any() and r[2]
