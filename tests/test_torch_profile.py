"""The step profiler's bookkeeping, and its rehearsal on the CPU (the
card's numbers come only from a run on the card)."""

import json

import numpy as np
import pytest
import torch

from fantoch_tpu_torch import cli, step_profile
from fantoch_tpu_torch.engine.driver import prepare_batch
from fantoch_tpu_torch.engine.faults import batch_fault_flags


@pytest.mark.parametrize(
    "intervals, busy",
    [
        ([], 0.0),
        ([(0, 2), (5, 6)], 3.0),
        ([(0, 4), (1, 2), (3, 7)], 7.0),      # nested and overlapping
        ([(5, 6), (0, 2), (2, 3)], 4.0),      # unsorted, touching
    ],
)
def test_busy_time_is_the_union_of_intervals(intervals, busy):
    assert step_profile._busy_us(intervals) == busy


def test_main_path_is_the_bench_grid():
    args = cli.parse_args(cli.MAIN_PATH)
    protocol, dims, specs = cli.sweep_setup(args)
    assert len(specs) == 256 * 2 * 4 and args.batch_lanes == 512
    assert (dims.N, dims.C, dims.M, dims.D) == (5, 5, 2069, 251)
    assert {s.config.f for s in specs} == {1, 2}
    assert {int(s.ctx["conflict_rate"]) for s in specs} == {0, 10, 50, 100}


def test_rehearsal_on_cpu_records_no_device_time():
    args = cli.parse_args([
        "sweep", "--protocol", "basic", "--n", "3", "--subsets", "1",
        "--fs", "1", "--conflicts", "0,100", "--commands", "3",
    ])
    protocol, dims, specs = cli.sweep_setup(args)
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    out = step_profile.profile(protocol, dims, state, ctx, dev, 3, 2)
    json.dumps(out)
    assert out["card"] == "cpu" and out["lanes"] == 2
    assert out["wall_ms_per_step"] > 0
    assert out["device_busy_ms_per_step"] is None
    assert out["device_activities_per_step"] == 0


def test_device_loop_rehearsal_on_cpu():
    """The device-loop mode on the host twin: its steps are the bodies
    it ran times a body's steps (one on the CPU), two windows of
    ``steps`` each after the warm-up segment."""
    args = cli.parse_args([
        "sweep", "--protocol", "basic", "--n", "3", "--subsets", "1",
        "--fs", "1", "--conflicts", "0,100", "--commands", "3",
    ])
    protocol, dims, specs = cli.sweep_setup(args)
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    out = step_profile.profile_device(protocol, dims, state, ctx, dev, 3, 2)
    json.dumps(out)
    assert out["loop"] == "device" and out["steps_per_body"] == 1
    assert out["steps"] == 3 and out["capture_s"] == 0.0
    assert out["device_busy_ms_per_step"] is None


def test_fpaxos_main_path_is_the_bench_grid_with_leader_1():
    from fantoch_tpu_torch.engine.protocols import FPaxosDev

    args = cli.parse_args(cli.MAIN_PATH_FPAXOS)
    protocol, dims, specs = cli.sweep_setup(args)
    assert protocol is FPaxosDev and len(specs) == 2048
    assert (dims.N, dims.C, dims.M, dims.D, dims.F, dims.P) == (
        5, 5, 2069, 251, 6, 3
    )
    assert {s.config.leader for s in specs} == {1}
    assert {int(s.ctx["leader"]) for s in specs} == {0}
    assert {int(s.ctx["q_size"]) for s in specs} == {2, 3}


def test_rehearsal_of_the_fpaxos_profile_on_cpu():
    args = cli.parse_args([
        "sweep", "--protocol", "fpaxos", "--n", "3", "--subsets", "1",
        "--fs", "1", "--conflicts", "0,100", "--commands", "3",
    ])
    protocol, dims, specs = cli.sweep_setup(args)
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    out = step_profile.profile(protocol, dims, state, ctx, dev, 3, 2)
    assert out["protocol"] == "FPaxosDev" and out["lanes"] == 2
    assert out["device_activities_per_step_by_name"] == {}


def test_tempo_main_path_is_the_bench_grid_at_the_cli_defaults():
    """The reference bench's grid at the reference CLI's Tempo defaults:
    detached sends every 100 ms, no clock bump, the load-sized capacity
    (K = 6, PK = 40, R = 20, G = 10)."""
    from fantoch_tpu_torch.engine.protocols import TempoDev

    args = cli.parse_args(cli.MAIN_PATH_TEMPO)
    protocol, dims, specs = cli.sweep_setup(args)
    assert protocol == TempoDev(keys=6, pending_per_key=40,
                                detached_slots=20, gap_slots=10)
    assert len(specs) == 2048
    assert (dims.N, dims.C, dims.M, dims.D, dims.F, dims.R, dims.P) == (
        5, 5, 2069, 251, 6, 3, 21
    )
    assert {s.config.tempo_detached_send_interval_ms for s in specs} == {100}
    assert {s.config.tempo_clock_bump_interval_ms for s in specs} == {None}
    assert {tuple(s.ctx["periodic_intervals"]) for s in specs} == {
        (100, 1 << 30, 100)
    }


def test_rehearsal_of_the_tempo_profile_on_cpu():
    args = cli.parse_args([
        "sweep", "--protocol", "tempo", "--n", "3", "--subsets", "1",
        "--fs", "1", "--conflicts", "0,100", "--commands", "3",
    ])
    protocol, dims, specs = cli.sweep_setup(args)
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    out = step_profile.profile(protocol, dims, state, ctx, dev, 3, 2)
    assert out["protocol"] == "TempoDev" and out["lanes"] == 2
    assert out["device_activities_per_step_by_name"] == {}


@pytest.mark.parametrize("name, expected_acks", [
    ("atlas", {3, 4}),          # n/2 + f, the coordinator acking itself
    ("epaxos", {2}),            # f = n/2 = 2: fast quorum 3, minus self
])
def test_graphdep_main_paths_are_the_bench_grid(name, expected_acks):
    """The reference bench's grid for Atlas and EPaxos at the CLI's
    sizing: K = 6 keys, Q = 6 dep slots, P = 5 + 2Q = 17 (W = 25),
    F = n + 1 + 2 drain slots, one GC timer row; the lane tree is 29
    protocol planes, 29,082 int32 words and 1,260 bool bytes per
    process."""
    from fantoch_tpu_torch.engine.protocols import AtlasDev, EPaxosDev

    args = cli.parse_args(cli.MAIN_PATHS[name])
    assert args.protocol == name
    protocol, dims, specs = cli.sweep_setup(args)
    cls = AtlasDev if name == "atlas" else EPaxosDev
    assert protocol == cls(keys=6, gap_slots=8) and len(specs) == 2048
    assert (dims.N, dims.C, dims.M, dims.D, dims.F, dims.R, dims.P) == (
        5, 5, 2069, 251, 8, 1, 17
    )
    assert {int(s.ctx["expected_acks"]) for s in specs} == expected_acks
    assert {int(s.ctx["fp_mode"]) for s in specs} == {int(name == "epaxos")}
    state = protocol.init_state(dims, specs[0].ctx)
    assert len(state) == 29
    words = sum(v.size for v in state.values() if v.dtype != bool)
    flags = sum(v.size for v in state.values() if v.dtype == bool)
    assert (words // dims.N, flags // dims.N) == (29082, 1260)


@pytest.mark.parametrize("name", ["atlas", "epaxos"])
def test_rehearsal_of_the_graphdep_profile_on_cpu(name):
    args = cli.parse_args([
        "sweep", "--protocol", name, "--n", "3", "--subsets", "1",
        "--fs", "1", "--conflicts", "0,100", "--commands", "3",
    ])
    protocol, dims, specs = cli.sweep_setup(args)
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    out = step_profile.profile(protocol, dims, state, ctx, dev, 3, 2)
    assert out["protocol"] == type(protocol).__name__ and out["lanes"] == 2
    assert out["device_activities_per_step_by_name"] == {}


def test_rehearsal_of_the_caesar_profile_on_cpu():
    args = cli.parse_args([
        "sweep", "--protocol", "caesar", "--n", "3", "--subsets", "1",
        "--fs", "1", "--conflicts", "0,100", "--commands", "3",
    ])
    protocol, dims, specs = cli.sweep_setup(args)
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    out = step_profile.profile(protocol, dims, state, ctx, dev, 3, 2)
    assert out["protocol"] == "CaesarDev" and out["lanes"] == 2
    assert out["device_activities_per_step_by_name"] == {}
    assert "caesar" in cli.MAIN_PATHS


def test_tempo_partial_main_path_is_the_cut_grid():
    """The partial path: 2 shards of the bench's n = 5 rows, 2 keys per
    command from a pool of 4, the first 64 region subsets × f ∈ {1, 2}
    × conflict ∈ {1, 10, 50, 100} (one 512-lane batch)."""
    args = cli.parse_args(cli.MAIN_PATHS["tempo_partial"])
    protocol, dims, specs = cli.sweep_setup(args)
    assert (protocol.S, protocol.KPC) == (2, 2) and len(specs) == 512
    assert args.batch_lanes == 512 and dims.N == 10
    assert {s.config.f for s in specs} == {1, 2}
    assert {s.config.shard_count for s in specs} == {2}
    assert {int(s.ctx["conflict_rate"]) for s in specs} == {1, 10, 50, 100}
    assert {int(s.ctx["pool_size"]) for s in specs} == {4}


def test_rehearsal_of_the_tempo_partial_profile_on_cpu():
    args = cli.parse_args([
        "sweep", "--protocol", "tempo", "--n", "3", "--shards", "2",
        "--pool-size", "4", "--subsets", "1", "--fs", "1",
        "--conflicts", "10,100", "--commands", "3",
    ])
    protocol, dims, specs = cli.sweep_setup(args)
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    out = step_profile.profile(protocol, dims, state, ctx, dev, 3, 2)
    assert out["protocol"] == "TempoPartialDev" and out["lanes"] == 2
    assert out["device_activities_per_step_by_name"] == {}


def test_atlas_partial_main_path_is_the_cut_grid():
    """The Atlas partial path: the Tempo partial grid with Atlas at 9
    commands per client (from 10 on the reference overflows a table on
    lanes of the grid)."""
    args = cli.parse_args(cli.MAIN_PATHS["atlas_partial"])
    protocol, dims, specs = cli.sweep_setup(args)
    assert type(protocol).__name__ == "AtlasPartialDev"
    assert (protocol.S, protocol.KPC) == (2, 2) and len(specs) == 512
    assert args.batch_lanes == 512 and dims.N == 10 and args.commands == 9
    assert {s.config.f for s in specs} == {1, 2}
    assert {s.config.shard_count for s in specs} == {2}
    assert {int(s.ctx["conflict_rate"]) for s in specs} == {1, 10, 50, 100}
    assert {int(s.ctx["pool_size"]) for s in specs} == {4}
    tempo = cli.parse_args(cli.MAIN_PATHS["tempo_partial"])
    assert ({k: v for k, v in vars(args).items()
             if k not in ("protocol", "commands")}
            == {k: v for k, v in vars(tempo).items()
                if k not in ("protocol", "commands")})


def test_rehearsal_of_the_atlas_partial_profile_on_cpu():
    args = cli.parse_args([
        "sweep", "--protocol", "atlas", "--n", "3", "--shards", "2",
        "--pool-size", "4", "--subsets", "1", "--fs", "1",
        "--conflicts", "10,100", "--commands", "3",
    ])
    protocol, dims, specs = cli.sweep_setup(args)
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    out = step_profile.profile(protocol, dims, state, ctx, dev, 3, 2)
    assert out["protocol"] == "AtlasPartialDev" and out["lanes"] == 2
    assert out["device_activities_per_step_by_name"] == {}


def test_tempo_faults_main_path_is_the_cut_grid():
    """The fault path: the Tempo grid's first 64 subsets, each point
    once per plan of the reference CLI's --faults example and the rest
    of the fault model (2,048 lanes in four 512-lane batches, every
    batch under the union of all five fault flags); a point's lanes
    share its workload, and its fault-free lane is the Tempo path's
    lane of that point."""
    from fantoch_tpu_torch.engine.faults import FaultFlags

    args = cli.parse_args(cli.MAIN_PATHS["tempo_faults"])
    protocol, dims, specs = cli.sweep_setup(args)
    assert len(specs) == 2048 and args.batch_lanes == 512
    for lo in range(0, 2048, 512):
        assert batch_fault_flags(specs[lo:lo + 512]) == FaultFlags(
            *(True,) * 5)
    tempo = cli.parse_args(cli.MAIN_PATHS["tempo"])
    _p, tdims, tspecs = cli.sweep_setup(tempo)
    assert tdims == dims
    for i in (0, 7, 511):
        clean = specs[4 * i]
        assert clean.fault_meta is None
        for k, v in tspecs[i].ctx.items():
            np.testing.assert_array_equal(v, clean.ctx[k], err_msg=k)
        for j in range(1, 4):
            assert specs[4 * i + j].fault_meta is not None
            np.testing.assert_array_equal(specs[4 * i + j].ctx["rng_key"],
                                          clean.ctx["rng_key"])


def test_rehearsal_of_the_tempo_faults_profile_on_cpu():
    args = cli.parse_args([
        "sweep", "--protocol", "tempo", "--n", "3", "--subsets", "1",
        "--fs", "1", "--conflicts", "100", "--commands", "3",
        "--faults", cli.TEMPO_FAULT_PLANS,
    ])
    protocol, dims, specs = cli.sweep_setup(args)
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev)
    out = step_profile.profile(protocol, dims, state, ctx, dev, 3, 2,
                               False, batch_fault_flags(specs))
    assert out["protocol"] == "TempoDev" and out["lanes"] == 4
    assert out["device_activities_per_step_by_name"] == {}


def test_tempo_fuzz_path_is_the_bench_fuzz_point():
    """The monitored path: the reference bench's fuzz self-check point
    (Tempo, n = 5, 256 schedules of 10 commands a client, seed 0xF022,
    mixed jitter, crash and drop plans), monitor keys = pool + clients."""
    from fantoch_tpu_torch.engine.faults import FaultFlags
    from fantoch_tpu_torch.mc.fuzz import FuzzSpec, point_lanes

    spec = FuzzSpec(**cli.BENCH_FUZZ)
    assert (spec.protocol, spec.n, spec.schedules, spec.commands_per_client,
            spec.seed) == ("tempo", 5, 256, 10, 0xF022)
    protocol, dims, specs, plans, mk = point_lanes(spec)
    assert len(specs) == 256 and mk == 1 + 5 and dims.N == 5
    assert batch_fault_flags(specs) == FaultFlags(True, False, True, True,
                                                  True)
    assert sum(1 for p in plans if p.crashes) > 0
    assert sum(1 for p in plans if p.drop_bp) > 0


def test_rehearsal_of_the_monitored_profile_on_cpu():
    from fantoch_tpu_torch.mc.fuzz import FuzzSpec, point_lanes

    protocol, dims, specs, _plans, mk = point_lanes(
        FuzzSpec(protocol="tempo", n=3, schedules=3, commands_per_client=2))
    dev = torch.device("cpu")
    state, ctx = prepare_batch(protocol, dims, specs, dev, mk)
    out = step_profile.profile(protocol, dims, state, ctx, dev, 3, 2,
                               False, batch_fault_flags(specs), mk)
    assert out["protocol"] == "TempoDev" and out["lanes"] == 3
    assert out["device_activities_per_step_by_name"] == {}


def test_open_loop_and_traffic_main_paths():
    """``step_profile --protocol tempo_open`` and ``tempo_traffic``: the
    Tempo grid's first 64 subsets (512 lanes), open-loop Poisson arrivals
    of mean gap 4 ms at load 100 with a window of 4, and the churn
    schedule (its key table sized for the rotated pool)."""
    from fantoch_tpu_torch.engine.protocols import TempoDev

    args = cli.parse_args(cli.MAIN_PATHS["tempo_open"])
    protocol, dims, specs = cli.sweep_setup(args)
    assert isinstance(protocol, TempoDev) and len(specs) == 512
    assert {s.arrival_meta["window"] for s in specs} == {4}
    assert {s.arrival_meta["name"] for s in specs} == {"poisson"}
    assert specs[0].ctx["ol_arrival"].shape == (dims.C, 52)
    assert cli.OPEN_LOADS == (50, 100, 200, 400)
    args = cli.parse_args(cli.MAIN_PATHS["tempo_traffic"])
    protocol, dims, specs = cli.sweep_setup(args)
    assert len(specs) == 512 and protocol.K == 4 + 5
    assert {s.traffic_meta["name"] for s in specs} == {"churn"}
    assert cli.TRAFFIC_PATHS == ("diurnal", "flash", "churn")
