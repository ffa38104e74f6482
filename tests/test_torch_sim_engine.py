"""The port's engine on the CPU against the port's host oracle, as the
reference's ``tests/test_engine_fpaxos.py`` and ``test_engine_basic.py``
hold the reference's engine to its oracle.

* FPaxos at (f, leader) = (1, 1), (1, 3), (2, 2), n = 3, three lanes of
  one batch: every client region's latency mean and the GC total (stable
  slots, counted at the f + 1 acceptors) equal;
* Basic on the AWS planet: the means equal;
* FPaxos and Basic at conflict 50 on the ``DeviceStream`` workload (the
  engine's own keys on the host): every region's histogram and issued
  count equal, and the stable totals;
* the lanes of small fuzz points (``mc/fuzz.py point_lanes``: jitter,
  crash and drop plans, monitored) against ``host_run`` of the same
  plan: which plan kinds are exact. Every lane's completed count is
  equal on FPaxos and Basic; every region's latency mean is equal on
  Basic's point, on FPaxos without jitter (``jitter_max`` 1, where no
  lane's readiness gate bounces) and on every lane that no bounce
  delayed. Under jitter a message can overtake its prerequisite (an
  MChosen its predecessor slot); the engine's gate bounces it by 1 ms
  where the oracle's executor buffers it, so the reference's own engine
  and oracle disagree on such lanes' FPaxos means (a few tenths of a ms
  to a few ms), and the port's agree with them. The FPaxos points are
  in the slow tier.

10 commands a client (the reference's tests run 50: each lane steps
through the plain twins here). Tolerance: none."""

import pytest

from fantoch_tpu_torch.client import ConflictPool, DeviceStream, Workload
from fantoch_tpu_torch.core import Config, Planet
from fantoch_tpu_torch.engine import EngineDims, make_lane, run_lanes
from fantoch_tpu_torch.engine.protocols import BasicDev, FPaxosDev
from fantoch_tpu_torch.mc import fuzz
from fantoch_tpu_torch.protocol import BY_NAME
from fantoch_tpu_torch.protocol.base import ProtocolMetricsKind
from fantoch_tpu_torch.sim import Runner
from torch_threads import one_torch_thread  # noqa: F401

COMMANDS = 10
PROCESS_REGIONS = ["asia-east1", "us-central1", "us-west1"]
CLIENT_REGIONS = ["us-west1", "us-west2"]
DEV = {"basic": BasicDev, "fpaxos": FPaxosDev}


def oracle(name, planet, config, key_gen, process_regions, client_regions):
    workload = Workload(
        shard_count=1, key_gen=key_gen, keys_per_command=1,
        commands_per_client=COMMANDS, payload_size=0,
    )
    runner = Runner(BY_NAME[name], planet, config, workload, 1,
                    list(process_regions), list(client_regions))
    metrics, _, latencies = runner.run(extra_sim_time_ms=1000)
    stable = sum(
        pm.get_aggregated(ProtocolMetricsKind.STABLE) or 0
        for pm, _em in metrics.values()
    )
    return latencies, stable


def engine(name, planet, configs, process_regions, client_regions,
           conflict=100):
    """One batch, a lane per config, run on the CPU."""
    dev = DEV[name]
    n = len(process_regions)
    total = COMMANDS * len(client_regions)
    dims = EngineDims.for_protocol(
        dev, n=n, clients=len(client_regions), payload=dev.payload_width(n),
        total_commands=total, dot_slots=total + 1,
        regions=len(client_regions),
    )
    specs = [
        make_lane(
            dev, planet, config, conflict_rate=conflict, pool_size=1,
            commands_per_client=COMMANDS, clients_per_region=1,
            process_regions=list(process_regions),
            client_regions=list(client_regions), dims=dims,
        )
        for config in configs
    ]
    results = run_lanes(dev, dims, specs, device="cpu")
    for res in results:
        assert not res.err, res.err_cause
    return results


def test_engine_fpaxos_matches_the_oracle():
    planet = Planet.new()
    configs = [Config(n=3, f=f, leader=leader, gc_interval_ms=100)
               for f, leader in [(1, 1), (1, 3), (2, 2)]]
    results = engine("fpaxos", planet, configs, PROCESS_REGIONS,
                     CLIENT_REGIONS)
    for config, res in zip(configs, results):
        lat, stable = oracle("fpaxos", planet, config,
                             ConflictPool(conflict_rate=100, pool_size=1),
                             PROCESS_REGIONS, CLIENT_REGIONS)
        for region in CLIENT_REGIONS:
            assert res.latency_mean(region) == lat[region][1].mean()
        assert int(res.protocol_metrics["stable"].sum()) == stable


def test_engine_basic_matches_the_oracle():
    planet = Planet.from_dataset("latency_aws_2021_02_13")
    regions = planet.regions()[:3]
    config = Config(n=3, f=1, gc_interval_ms=100)
    lat, _ = oracle("basic", planet, config,
                    ConflictPool(conflict_rate=100, pool_size=1), regions,
                    regions[:2])
    [res] = engine("basic", planet, [config], regions, regions[:2])
    for region in regions[:2]:
        assert res.latency_mean(region) == lat[region][1].mean()


@pytest.mark.parametrize("name", ["basic", "fpaxos"])
def test_engine_matches_the_oracle_on_the_device_stream(name):
    planet = Planet.new()
    regions = planet.regions()[:3]
    config = Config(n=3, f=1, gc_interval_ms=100,
                    leader=1 if name == "fpaxos" else None)
    lat, stable = oracle(name, planet, config,
                         DeviceStream(conflict_rate=50, pool_size=1), regions,
                         regions)
    [res] = engine(name, planet, [config], regions, regions, conflict=50)
    for region in regions:
        issued, hist = lat[region]
        assert res.issued(region) == issued == COMMANDS
        assert res.histogram(region).all_values() == hist.all_values()
    assert int(res.protocol_metrics["stable"].sum()) == stable


def _per_region(hists):
    return {r: (h.count(), h.mean()) for r, h in hists.items() if h.count()}


@pytest.mark.parametrize("name,jitter_max", [
    # the FPaxos points step through the twins for about 80 s each
    pytest.param("fpaxos", 1, marks=pytest.mark.slow),
    pytest.param("fpaxos", 8, marks=pytest.mark.slow),
    ("basic", 8)])
def test_fuzz_lanes_against_the_oracle(name, jitter_max):
    # seed 2 draws a drop, a clean and a crash plan
    spec = fuzz.FuzzSpec(protocol=name, n=3, f=1, schedules=3,
                         commands_per_client=3, seed=2, crash_share=0.34,
                         drop_share=0.33, drop_horizon_ms=2000,
                         jitter_max=jitter_max)
    dev, dims, specs, plans, mk = fuzz.point_lanes(spec)
    results = run_lanes(dev, dims, specs, device="cpu", monitor_keys=mk)
    kinds = set()
    for plan, res in zip(plans, results):
        kinds.add("crash" if plan.crashes else "drop" if plan.drop_bp
                  else "clean")
        _m, _mon, lat, _p = fuzz.host_run(spec, plan)
        host = _per_region({r: h for r, (_i, h) in lat.items()})
        card = _per_region({r: res.histogram(r) for r in res.region_rows})
        assert res.completed == sum(c for c, _ in host.values())
        if name == "basic" or jitter_max == 1 or res.requeues == 0:
            # a lane whose readiness gate bounced nothing is exact
            assert card == host, plan.meta()
    assert kinds == {"crash", "drop", "clean"}
    if jitter_max == 1:
        assert not any(r.requeues for r in results)


def test_jittered_fpaxos_means_differ_through_gate_bounces(monkeypatch):
    """Why a jittered FPaxos lane's latency means differ between the
    engine and the oracle (on the reference's side too): jitter lets an
    MChosen overtake its predecessor slot's; the engine's readiness gate
    bounces it by 1 ms a pop until its predecessor has executed, where
    the oracle's slot executor buffers it and executes both at once. So
    the first slot whose execution time differs between the two
    executes later on the engine, after bounces (here the leader's slot
    4: popped at 162 ms and bounced to 172, executed at 171 on the
    oracle)."""
    from fantoch_tpu_torch.engine import core
    from fantoch_tpu_torch.engine.dims import PMT, PPAY
    from fantoch_tpu_torch.protocol.fpaxos import MChosen
    from fantoch_tpu_torch.sim import runner as sim_runner

    spec = fuzz.FuzzSpec(protocol="fpaxos", n=3, f=1, schedules=1,
                         commands_per_client=2, seed=0,
                         extra_time_ms=200)
    dev, dims, specs, plans, mk = fuzz.point_lanes(spec)
    assert plans[0].jitter_max == 8 and not plans[0].crashes
    pops = {}  # (process, slot) -> MChosen pop times on the engine
    pop = core.qualify_pop

    def recorded(*a, **kw):
        out = pop(*a, **kw)
        ep, has, rows = out[1], out[6], out[7]
        for p in has[0].nonzero().flatten().tolist():
            if int(rows[0, p, PMT]) == FPaxosDev.MCHOSEN:
                pops.setdefault((p + 1, int(rows[0, p, PPAY])), []).append(
                    int(ep[0, p]))
        return out

    arrived = {}  # (process, slot) -> MChosen arrival on the oracle
    handle = sim_runner.Runner._handle_send

    def delivered(self, from_, shard, pid, msg):
        if isinstance(msg, MChosen):
            arrived[(pid, msg.slot)] = self.simulation.time.millis()
        return handle(self, from_, shard, pid, msg)

    monkeypatch.setattr(core, "qualify_pop", recorded)
    [res] = run_lanes(dev, dims, specs, device="cpu", monitor_keys=mk)
    monkeypatch.setattr(sim_runner.Runner, "_handle_send", delivered)
    _m, _mon, lat, _p = fuzz.host_run(spec, plans[0])
    host = _per_region({r: h for r, (_i, h) in lat.items()})
    card = _per_region({r: res.histogram(r) for r in res.region_rows})
    assert res.requeues > 0 and card != host
    assert {r: c for r, (c, _) in card.items()} == {
        r: c for r, (c, _) in host.items()}
    assert set(pops) == set(arrived)
    # the oracle executes slot s at the last arrival of slots 1..s; the
    # engine at the pop that passed the gate, its last
    executed = {}
    for (pid, slot) in sorted(arrived):
        executed[(pid, slot)] = max(arrived[(pid, slot)],
                                    executed.get((pid, slot - 1), 0))
    # the first slot whose execution differs (a divergence moves later
    # commands and which message each channel's jitter draw delays)
    diff = sorted((min(pops[k][-1], executed[k]), k) for k in pops
                  if pops[k][-1] != executed[k])
    assert diff
    first = diff[0][1]
    assert pops[first][-1] > executed[first], (first, pops[first])
    assert len(pops[first]) > 1, (first, pops[first], executed[first])
    assert (first, pops[first][0], pops[first][-1], executed[first]) == (
        (1, 4), 162, 172, 171)
