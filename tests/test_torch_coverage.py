"""Coverage-guided fuzzing (``fantoch_tpu_torch/mc/coverage.py`` and
``mc/covmap.py``) against the reference's on the CPU.

Host side: the coverage map (observe, JSON round trip, refusals with the
reference's messages), point signatures, the seed pool, ``mutate_plan``,
``draw_steered`` (chunked equals one shot across a journal hop, per fault
class, and equals the reference's plans), ``frontier_weights``,
``discovery_rate`` and ``rank_points``, and the binary map format (the
reference's bytes, compaction, migration, refusals). Device side (the
monitored Basic runner at ``tests/test_coverage.py``'s shapes, on the
CPU): a steered campaign and a class-sharded farm with binary maps,
interrupted and resumed, give the reference's ``summary.json`` and
final map bytes; plateau retirement retires the reference's point at the
reference's chunk across an interruption; a foreign journaled map is
refused by name. ``tests/test_coverage.py``'s fleet tests belong to the
fleet layer and are not here. Tolerance: none."""

import json
import os
import shutil

import pytest

from fantoch_tpu.campaign import campaign_from_json as r_from_json
from fantoch_tpu.campaign import run_campaign as r_run
from fantoch_tpu.mc import coverage as rcov
from fantoch_tpu.mc import covmap as rcvm
from fantoch_tpu.mc import fuzz as rfuzz
from fantoch_tpu_torch.campaign import CampaignError, campaign_from_json
from fantoch_tpu_torch.campaign import run_campaign
from fantoch_tpu_torch.mc import coverage as cov
from fantoch_tpu_torch.mc import covmap as cvm
from fantoch_tpu_torch.mc import fuzz
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_coverage.py's grid: the monitored Basic runner, 6 schedules
# in chunks of 2
COV_GRID = {
    "kind": "fuzz",
    "protocols": ["basic"],
    "ns": [3],
    "schedules": 6,
    "chunk": 2,
    "commands_per_client": 3,
    "seed": 1,
    "confirm": False,
    "crash_share": 0.0,
    "drop_share": 0.0,
    "coverage": True,
}
FARM_GRID = dict(COV_GRID, classes=["crash", "jitter"], crash_share=0.3,
                 drop_share=0.2, binary_maps=True)
RETIRE_GRID = dict(COV_GRID, schedules=20, classes=["jitter"],
                   retire_after=2, jitter_max=1)
SIDES = {"port": (cov, fuzz), "ref": (rcov, rfuzz)}


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _run(path, spec=None, **kw):
    return run_campaign(str(path), spec, device="cpu", **kw)


def _both(fn):
    """``fn(cov_module, fuzz_module)`` on the port's side and the
    reference's."""
    return fn(cov, fuzz), fn(rcov, rfuzz)


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is compared
        return type(e).__name__, str(e)
    raise AssertionError("no refusal")


# ----------------------------------------------------------------------
# the coverage map, signatures, seeds (host-only)
# ----------------------------------------------------------------------


def test_coverage_map_matches_the_reference():
    def run(c, f):
        m = c.CoverageMap(signature={"protocol": "tempo"})
        out = [m.observe([7, 7, -3, 9]), dict(m.buckets), m.bucket_count,
               m.new_buckets([7, 11, 11]), m.observe([7, 11]),
               dict(m.buckets)]
        sig = c.point_signature(f.FuzzSpec(protocol="tempo", n=3, seed=4))
        m = c.CoverageMap(signature=sig)
        m.observe([5, -1, 5])
        obj = json.loads(json.dumps(m.to_json(), sort_keys=True))
        back = c.CoverageMap.from_json(obj, signature=sig)
        other = c.point_signature(f.FuzzSpec(protocol="fpaxos", n=5,
                                             seed=4))
        out += [obj, json.dumps(back.to_json(), sort_keys=True),
                _err(lambda: c.CoverageMap.from_json({"kind": "nope"})),
                _err(lambda: c.CoverageMap.from_json(dict(obj,
                                                          version=999))),
                _err(lambda: c.CoverageMap.from_json(obj, signature=other)),
                _err(lambda: c.CoverageMap.from_json(
                    dict(obj, buckets=None)))]
        return out

    got, want = _both(run)
    assert got == want
    assert got[0] == [7, -3, 9] and got[3] == 1
    assert issubclass(cov.CoverageMismatchError, CampaignError)


def test_point_signatures_match_the_reference():
    variants = [
        dict(protocol="tempo", n=3, seed=0),
        dict(protocol="atlas", n=3, seed=0),
        dict(protocol="tempo", n=5, seed=0),
        dict(protocol="tempo", n=3, seed=1, conflict=0),
        dict(protocol="tempo", n=3, seed=0, inject_bug=True),
        dict(protocol="tempo", n=3, seed=0, crash_share=0.0),
        dict(protocol="tempo", n=3, seed=0, jitter_max=4, aws=True),
    ]

    def run(c, f):
        sigs = [c.point_signature(f.FuzzSpec(**kw)) for kw in variants]
        base = f.FuzzSpec(protocol="tempo", n=3, seed=11)
        sigs += [c.point_signature(f.class_spec(base, k))
                 for k in ("mixed", "crash", "drop", "jitter")]
        return sigs

    got, want = _both(run)
    assert got == want
    assert len({json.dumps(s, sort_keys=True) for s in got}) == len(got)


def test_seed_pool_matches_the_reference():
    def run(c, f):
        spec = f.FuzzSpec(protocol="tempo", n=3, schedules=c.MAX_SEEDS + 9,
                          seed=2, crash_share=0.3, drop_share=0.3)
        plans = f.draw_plans(spec, f.point_config(spec),
                             f.point_protocol(spec))
        pool = c.SeedPool()
        for i, p in enumerate(plans):
            pool.add(p, digest=None if i % 3 else i * 7919)
        pool.add(plans[-1])
        back = c.SeedPool.from_json(json.loads(json.dumps(pool.to_json())),
                                    digests=pool.digests_json())
        return (pool.to_json(), pool.digests_json(), len(pool),
                back.get(0).meta(), c.plan_to_json(back.get(3)))

    got, want = _both(run)
    assert got == want and got[2] == cov.MAX_SEEDS


def test_mutate_plan_matches_the_reference():
    """Four mutations of every seed of a mixed point and of a fault-free
    point: the reference's mutants, all seeded, within ``min_live``,
    inside the point's fault envelope."""

    def run(c, f):
        out = []
        for kw in (dict(protocol="tempo", n=3, schedules=24, seed=5,
                        crash_share=0.4, drop_share=0.3),
                   dict(protocol="atlas", n=5, f=2, schedules=12, seed=2,
                        crash_share=0.5, drop_share=0.2),
                   dict(protocol="tempo", n=3, schedules=8, seed=5,
                        crash_share=0.0, drop_share=0.0)):
            spec = f.FuzzSpec(**kw)
            config, dev = f.point_config(spec), f.point_protocol(spec)
            rng = c.mutation_rng(spec)
            for seed in f.draw_plans(spec, config, dev):
                for _ in range(4):
                    m = c.mutate_plan(seed, rng, spec, config, dev)
                    assert not m.host_only()
                    assert not (m.crashes and m.drop_bp)
                    if not spec.crash_share:
                        assert not m.crashes and not m.drop_bp
                    out.append(c.plan_to_json(m))
        return out

    got, want = _both(run)
    assert got == want


@pytest.mark.parametrize("fault_class", ["mixed", "crash", "drop",
                                         "jitter"])
def test_draw_steered_chunked_equals_one_shot_and_the_reference(
        fault_class):
    def run(c, f):
        spec = f.class_spec(
            f.FuzzSpec(protocol="tempo", n=3, schedules=12, seed=11,
                       crash_share=0.3, drop_share=0.2), fault_class)
        config, dev = f.point_config(spec), f.point_protocol(spec)
        pool = c.SeedPool()
        for p in f.draw_plans(spec, config, dev)[:5]:
            pool.add(p)
        one = c.draw_steered(spec, config, dev, 12, f.plan_rng(spec),
                             c.mutation_rng(spec), pool)
        rng, mrng = f.plan_rng(spec), c.mutation_rng(spec)
        first = c.draw_steered(spec, config, dev, 5, rng, mrng, pool)
        r_state = json.loads(json.dumps(f.rng_state(rng)))
        m_state = json.loads(json.dumps(f.rng_state(mrng)))
        pool2 = c.SeedPool.from_json(json.loads(json.dumps(pool.to_json())))
        rest = c.draw_steered(spec, config, dev, 7, f.restore_rng(r_state),
                              f.restore_rng(m_state), pool2)
        assert first + rest == one
        dry = c.draw_steered(spec, config, dev, 6, f.plan_rng(spec),
                             c.mutation_rng(spec), c.SeedPool())
        assert dry == f.draw_plans(spec, config, dev, count=6)
        return [c.plan_to_json(p) for p in one]

    got, want = _both(run)
    assert got == want


def test_frontier_weights_and_the_weighted_draw_match_the_reference():
    def run(c, f):
        spec = f.FuzzSpec(protocol="tempo", n=3, schedules=6, seed=3)
        config, dev = f.point_config(spec), f.point_protocol(spec)
        cmap = c.CoverageMap(signature=c.point_signature(spec))
        cmap.observe([0b0000, 0b0001, 0b0011, 0b1111000011110000, -5])
        pool = c.SeedPool()
        plans = f.draw_plans(spec, config, dev)
        pool.add(plans[0], digest=0b0000)
        pool.add(plans[1], digest=0b1111000011110000)
        pool.add(plans[2], digest=None)
        pool.add(plans[3], digest=-5)
        w = c.frontier_weights(pool, cmap)
        draw = c.draw_steered(spec, config, dev, 10, f.plan_rng(spec),
                              c.mutation_rng(spec), pool, cmap=cmap)
        return (w, c.frontier_weights(pool, None),
                [c.plan_to_json(p) for p in draw])

    got, want = _both(run)
    assert got == want
    w = got[0]
    assert w[2] == 1 and w[1] > w[0] > 1


def test_discovery_rate_and_rank_points_match_the_reference():
    points = [("tempo", 3), ("tempo", 5), ("fpaxos", 3), ("atlas", 3)]
    triples = [("basic", 3, "crash"), ("basic", 3, "jitter"),
               ("basic", 5, "mixed")]
    progress = {
        "tempo/n3": {"tried": 40, "cov_recent": [[8, 6]]},
        "tempo/n5": {"tried": 40, "cov_recent": [[8, 0]]},
        "fpaxos/n3": {"tried": 4, "cov_recent": [[4, 0]]},
        "atlas/n3": {"tried": 2, "cov_recent": [[2, 2]]},
        "basic/n3/crash": {"tried": 8, "cov_recent": [[4, 1], [4, 3]]},
        "basic/n3/jitter": {"tried": 8, "cov_recent": [[4, 2]]},
    }

    def run(c, _f):
        return [
            c.rank_points(points, progress, 100, min_share=0.25),
            c.rank_points(points, progress, 40, min_share=0.25),
            c.rank_points(points, progress, 100, retired=["fpaxos/n3"]),
            c.rank_points(points, progress, 100,
                          composition={"tempo": 6, "atlas": 1}),
            c.rank_points(triples, progress, 20),
            c.rank_points(points, {}, 0),
            [c.discovery_rate(progress.get(k)) for k in
             ("tempo/n3", "basic/n3/crash", "nope")],
            c.parse_point_key("basic/n3/crash"),
            c.point_class_key("tempo", 5, "mixed"),
        ]

    got, want = _both(run)
    assert got == want
    assert got[0] == ["fpaxos/n3", "atlas/n3", "tempo/n3", "tempo/n5"]


# ----------------------------------------------------------------------
# binary coverage maps (host-only)
# ----------------------------------------------------------------------


def _map(c, f):
    sig = c.point_signature(f.FuzzSpec(protocol="tempo", n=3, seed=4))
    m = c.CoverageMap(signature=sig)
    m.observe([5, -1, 5, 1 << 62, -(1 << 62)])
    return m, sig


def test_binary_covmap_bytes_compaction_and_migration(tmp_path):
    out = {}
    for side, (c, f) in SIDES.items():
        v = cvm if side == "port" else rcvm
        m, sig = _map(c, f)
        data = v.covmap_bytes(m)
        back = v.covmap_from_bytes(data, signature=sig)
        assert v.covmap_bytes(back) == data
        d = tmp_path / side / "farm"
        key = "tempo/n3/crash"
        for tried in (2, 4, 6):
            m.observe([tried])
            v.save_point_map(str(d), key, tried, m)
        removed = v.compact_point_maps(str(d), key, keep=2)
        tried, latest = v.latest_point_map(str(d), key, signature=sig)
        cd = tmp_path / side / "covdir"
        c.save_point_state(str(cd), f.FuzzSpec(protocol="tempo", n=3,
                                               seed=4),
                           {"kind": "fuzz-coverage", "tried": 6,
                            "coverage": m.to_json(), "seeds": []})
        before = _read(cd / "cov_tempo_n3.json")
        written = v.migrate_point_states(str(cd))
        assert _read(cd / "cov_tempo_n3.json") == before
        again = v.migrate_point_states(str(cd))
        out[side] = dict(
            data=data,
            names=sorted(os.listdir(d / "covmaps")),
            files=[_read(d / "covmaps" / n)
                   for n in sorted(os.listdir(d / "covmaps"))],
            removed=[os.path.basename(p) for p in removed],
            latest=(tried, latest.buckets),
            written=[os.path.basename(p) for p in written],
            again=[os.path.basename(p) for p in again],
            migrated=_read(written[0]),
            final=v.final_map_path("D", key),
        )
    assert out["port"] == out["ref"]
    assert out["port"]["names"] == [
        "tempo_n3_crash.t00000004.covmap", "tempo_n3_crash.t00000006.covmap"]


def test_binary_covmap_refusals_match_the_reference(tmp_path):
    def run(c, f):
        v = cvm if c is cov else rcvm
        m, sig = _map(c, f)
        data = v.covmap_bytes(m)
        other = c.point_signature(f.FuzzSpec(protocol="fpaxos", n=5, seed=4))
        foreign = data[:8] + (99).to_bytes(4, "little") + data[12:]
        bad_magic = b"NOTAMAP\x00" + data[8:]
        tampered = bytearray(data)
        tampered[60] ^= 0xFF
        missing = tmp_path / "none.covmap"
        d = tmp_path / ("p" if c is cov else "r")
        d.mkdir()
        (d / "cov_x.json").write_text("{")
        return [
            _err(lambda: v.covmap_from_bytes(foreign, signature=sig)),
            _err(lambda: v.covmap_from_bytes(data, signature=other)),
            _err(lambda: v.covmap_from_bytes(data[:-3], signature=sig)),
            _err(lambda: v.covmap_from_bytes(data[:10])),
            _err(lambda: v.covmap_from_bytes(bad_magic)),
            _err(lambda: v.covmap_from_bytes(bytes(tampered))),
            _err(lambda: v.load_covmap(str(missing)))[0],
            _err(lambda: v.migrate_point_states(str(tmp_path / "nodir"))),
            _err(lambda: v.migrate_point_states(str(d)))[0],
        ]

    got, want = _both(run)
    assert got == want
    assert got[0][0] == "CovmapVersionError"
    assert got[1][0] == "CoverageMismatchError"
    assert issubclass(cvm.CovmapError, cov.CoverageError)
    assert issubclass(cvm.CovmapVersionError, cov.CoverageMismatchError)


# ----------------------------------------------------------------------
# steered campaigns and the farm (device tier, Basic on the CPU)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's uninterrupted runs of the three grids."""
    out = {}
    for name, grid in (("cov", COV_GRID), ("farm", FARM_GRID),
                       ("retire", RETIRE_GRID)):
        path = tmp_path_factory.mktemp(f"ref_{name}")
        assert r_run(str(path), r_from_json(grid))["done"]
        out[name] = path
    return out


@pytest.fixture(scope="module")
def steered(tmp_path_factory):
    """The port's ``COV_GRID`` stopped by a zero budget after one chunk
    (a copy of the directory kept), then resumed."""
    path = tmp_path_factory.mktemp("steered")
    s1 = _run(path, campaign_from_json(COV_GRID), budget_s=0.0)
    snap = tmp_path_factory.mktemp("snap") / "c"
    shutil.copytree(path, snap)
    s2 = _run(path, resume=True)
    return s1, s2, path, snap


def _final_entry(path):
    lines = [json.loads(x) for x in open(os.path.join(path,
                                                      "journal.jsonl"))]
    return [e for e in lines if e.get("kind") == "fuzz"][-1]


def test_steered_campaign_resume_matches_the_reference(steered, ref_runs):
    s1, s2, path, _snap = steered
    assert not s1["done"] and s1["interrupted"] == "budget exhausted"
    assert s1["points"]["basic/n3"]["tried"] == 2
    assert s2["done"] and s2["points"]["basic/n3"]["cov_buckets"] > 0
    ref = ref_runs["cov"]
    assert _read(path / "summary.json") == _read(ref / "summary.json")
    assert _read(path / "campaign.json") == _read(ref / "campaign.json")
    a, b = _final_entry(path), _final_entry(ref)
    for key in ("coverage", "seeds", "seed_digests", "rng_state",
                "mrng_state", "cov_recent", "tried", "cov_dry"):
        assert a[key] == b[key], key


def test_steered_campaign_refuses_a_foreign_map(steered, tmp_path):
    _s1, _s2, _path, snap = steered
    path = tmp_path / "c"
    shutil.copytree(snap, path)
    jpath = path / "journal.jsonl"
    entries = [json.loads(x) for x in open(jpath)]
    entries[-1]["coverage"]["signature"]["protocol"] = "tempo"
    jpath.write_text("".join(json.dumps(e, sort_keys=True) + "\n"
                             for e in entries))
    with pytest.raises(cov.CoverageMismatchError, match="protocol"):
        _run(path, resume=True)


def test_farm_with_binary_maps_resumes_to_the_reference_bytes(
        tmp_path, ref_runs):
    ref = ref_runs["farm"]
    s = _run(tmp_path, campaign_from_json(FARM_GRID), budget_s=0.0)
    assert not s["done"]
    s = _run(tmp_path, resume=True)
    assert s["done"]
    assert set(s["points"]) == {"basic/n3/crash", "basic/n3/jitter"}
    assert _read(tmp_path / "summary.json") == _read(ref / "summary.json")
    finals = sorted(os.listdir(tmp_path / "covmaps"))
    assert finals == sorted(os.listdir(ref / "covmaps")) == [
        "basic_n3_crash.covmap", "basic_n3_jitter.covmap"]
    for name in finals:
        assert _read(tmp_path / "covmaps" / name) == _read(
            ref / "covmaps" / name), name
    for e in map(json.loads, open(tmp_path / "journal.jsonl")):
        if e.get("kind") == "fuzz":
            assert "coverage" not in e and "cov_sha256" in e
    # a summarized farm re-summarizes from its final maps (sha-checked)
    again = _run(tmp_path, resume=True)
    assert again["done"]
    assert _read(tmp_path / "summary.json") == _read(ref / "summary.json")


def test_retirement_matches_the_reference_across_interruption(
        tmp_path, ref_runs):
    ref = ref_runs["retire"]
    _run(tmp_path, campaign_from_json(RETIRE_GRID), budget_s=0.0)
    _run(tmp_path, resume=True, budget_s=0.0)
    s = _run(tmp_path, resume=True)
    assert s["done"] and s["retired"] == ["basic/n3/jitter"]
    assert s["points"]["basic/n3/jitter"]["tried"] == 6
    assert _read(tmp_path / "summary.json") == _read(ref / "summary.json")
    retire = [e for e in map(json.loads, open(tmp_path / "journal.jsonl"))
              if e.get("kind") == "retire"]
    assert retire == [{"kind": "retire", "point": "basic/n3/jitter",
                       "tried": 6, "cov_dry": 2}]
    before = _read(tmp_path / "journal.jsonl")
    assert _run(tmp_path, resume=True)["done"]
    assert _read(tmp_path / "journal.jsonl") == before


@pytest.mark.slow
def test_fuzz_summary_reads_journaled_counters_as_the_reference(tmp_path):
    grid = dict(COV_GRID, schedules=5, coverage=False)
    assert r_run(str(tmp_path / "ref"), r_from_json(grid))["done"]
    path = tmp_path / "c"
    s = _run(path, campaign_from_json(grid), budget_s=0.0)
    assert s["schedules_tried"] == 2
    s = _run(path, resume=True)
    assert s["done"] and s["schedules_tried"] == 5
    assert _read(path / "summary.json") == _read(
        tmp_path / "ref" / "summary.json")
    tried = [e["tried"] for e in map(json.loads, open(path / "journal.jsonl"))
             if e.get("kind") == "fuzz"]
    assert tried == [2, 4, 5]


@pytest.mark.slow
def test_legacy_campaign_json_resumes_as_the_reference(tmp_path):
    """A pre-farm ``campaign.json`` (without the farm fields) resumes to
    the reference's summary."""
    ref = tmp_path / "ref"
    assert r_run(str(ref), r_from_json(COV_GRID))["done"]
    path = tmp_path / "c"
    _run(path, campaign_from_json(COV_GRID), budget_s=0.0)
    stored = json.load(open(path / "campaign.json"))
    for k in ("classes", "retire_after", "binary_maps"):
        stored.pop(k)
    (path / "campaign.json").write_text(json.dumps(stored, indent=2,
                                                   sort_keys=True))
    s = _run(path, resume=True)
    assert s["done"] and set(s["points"]) == {"basic/n3"}
    assert _read(path / "summary.json") == _read(ref / "summary.json")


@pytest.mark.slow
def test_tempo_steered_campaign_resume_matches_the_reference(tmp_path):
    grid = {"kind": "fuzz", "protocols": ["tempo"], "ns": [3],
            "schedules": 8, "chunk": 4, "commands_per_client": 5,
            "seed": 7, "confirm": False, "coverage": True}
    ref = tmp_path / "ref"
    assert r_run(str(ref), r_from_json(grid))["done"]
    path = tmp_path / "c"
    _run(path, campaign_from_json(grid), budget_s=0.0)
    assert _run(path, resume=True)["done"]
    assert _read(path / "summary.json") == _read(ref / "summary.json")
