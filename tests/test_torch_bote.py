"""bote (``fantoch_tpu_torch/bote``) and K15's plain twin against the
reference's ``fantoch_tpu/bote`` on the CPU.

The twin of K15 (``kernels/bote_stats.py``) equals the reference's
``batched_config_stats`` on every subset of the GCP planet at n = 3 and 5
(n = 7 to 13 in the slow tier), of the AWS planet at n = 3 and 5, of an
equidistant planet (every distance tied) and of two seeded random
integer planets (one with many ties): every latency plane, the leader and
the FPaxos latencies of f = 1 and 2 exactly, and the COV plane bit for
bit against the reference's own f32 ops in the reference's own layout
(which sums sequentially in client order; a contiguous copy, summed
pairwise, differs on some rows, so the check holds the order itself).
``Search.rank(device="cpu")`` equals the reference's ``rank()`` (scores,
configs and means exactly) at ``f1`` and ``f1f2`` and under tighter
params; ``compute_stats`` and the host ``Bote`` equal the reference's;
the search cache round-trips, and a cache the reference wrote is
recomputed without importing the reference (a subprocess checks
``sys.modules``); ``--device cpu bote`` prints the reference CLI's
bytes; ``bote --validate`` (dry run, and a small measured FPaxos
validation) writes the reference's frontier artifact bytes; without a
GPU every entry point raises. Tolerance: none."""

import contextlib
import importlib
import io
import itertools
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fantoch_tpu import cli as rcli
from fantoch_tpu.bote import model as rmodel
from fantoch_tpu.bote import search as rsearch
from fantoch_tpu.bote import validate as rvalidate
from fantoch_tpu.core import Planet as RPlanet
from fantoch_tpu_torch import cli
from fantoch_tpu_torch.bote import (
    Bote, FTMetric, ProtocolModel, RankingParams, Search,
    batched_config_stats, compute_stats,
)
from fantoch_tpu_torch.bote import validate
from fantoch_tpu_torch.core import Planet
from torch_threads import one_torch_thread  # noqa: F401

# the module (the package exports its wrapper under the same name)
bote_stats = importlib.import_module("fantoch_tpu_torch.kernels.bote_stats")
ROOT = Path(__file__).resolve().parent.parent
AWS = "latency_aws_2021_02_13"


def _random_planet(seed, regions, high):
    """A seeded symmetric planet of integer distances in [1, high), zero
    on the diagonal (a small ``high`` gives many ties)."""
    rng = np.random.default_rng(seed)
    names = [f"x{i:02d}" for i in range(regions)]
    m = rng.integers(1, high, size=(regions, regions))
    m = np.triu(m, 1)
    m = m + m.T
    return {a: {b: int(m[i, j]) for j, b in enumerate(names)}
            for i, a in enumerate(names)}


def _planets(name):
    """``(reference planet, port planet)`` by name."""
    if name == "gcp":
        return RPlanet.new(), Planet.new()
    if name == "aws":
        return RPlanet.from_dataset(AWS), Planet.from_dataset(AWS)
    if name == "equidistant":
        _r, rp = RPlanet.equidistant(100, 9)
        _p, pp = Planet.equidistant(100, 9)
        return rp, pp
    seed, regions, high = {"random": (7, 11, 400),
                           "random_ties": (3, 10, 6)}[name]
    lat = _random_planet(seed, regions, high)
    return RPlanet.from_latencies(lat), Planet.from_latencies(lat)


def test_planet_matches_the_reference():
    for rp, pp in (_planets("gcp"), _planets("aws"),
                   _planets("equidistant"), _planets("random")):
        regions = sorted(rp.regions())
        assert sorted(pp.regions()) == regions
        np.testing.assert_array_equal(pp.latency_matrix(regions),
                                      rp.latency_matrix(regions))
        assert pp.latency_matrix(regions).dtype == np.int32
        assert pp.distance_matrix(regions[:4]) == rp.distance_matrix(
            regions[:4])
        for r in regions[:3]:
            assert pp.sorted(r) == rp.sorted(r)
    assert Planet.equidistant(5, 3)[0] == RPlanet.equidistant(5, 3)[0]


def _ref_cov(lat, subsets, clients, lq):
    """The reference's per-leader COV, through its own f32 numpy ops in
    its own layout (``bote/model.py:138-146``)."""
    within = lat[subsets[:, :, None], subsets[:, None, :]]
    quorum_lat = np.sort(within, axis=2)[:, :, lq - 1]
    c2s = lat[clients[None, :, None], subsets[:, None, :]]
    per_leader = np.swapaxes(c2s, 1, 2) + quorum_lat[:, :, None]
    mean = np.mean(per_leader, axis=2)
    std = np.std(per_leader, axis=2)
    return std / np.maximum(mean, 1e-9), per_leader


def _ref_fpaxos(lat, subsets, clients, leader, q):
    """The reference's FPaxos latencies with the f=1 leader
    (``bote/search.py:216-226, :244-250``)."""
    c2s = lat[clients[None, :, None], subsets[:, None, :]]
    within_sorted = np.sort(lat[subsets[:, :, None], subsets[:, None, :]],
                            axis=2)
    c2l = np.take_along_axis(c2s, leader[:, None, None], axis=2)[:, :, 0]
    lq = np.take_along_axis(within_sorted[:, :, q - 1], leader[:, None],
                            axis=1)
    return c2l + lq


def _twin_case(planet_name, n):
    rp, pp = _planets(planet_name)
    regions = sorted(rp.regions())
    lat = rp.latency_matrix(regions).astype(np.float32)
    assert np.array_equal(lat, pp.latency_matrix(regions).astype(np.float32))
    subsets = np.asarray(list(itertools.combinations(range(len(regions)),
                                                     n)))
    clients = np.arange(len(regions))
    fs = FTMetric.fs(FTMetric.F1F2, n)
    quorums = sorted({ProtocolModel.atlas(n, f) for f in fs}
                     | {ProtocolModel.epaxos(n)})
    fq = [ProtocolModel.fpaxos(n, f) for f in fs]
    ref = rmodel.batched_config_stats(lat, subsets, clients, quorums,
                                      leader_quorum_size=2)
    got = batched_config_stats(lat, subsets, clients, quorums, 2,
                               leader_quorum_sizes=fq, device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    for q in quorums:
        assert got[f"lat_{q}"].dtype == np.float32
        np.testing.assert_array_equal(got[f"lat_{q}"], ref[f"lat_{q}"])
    np.testing.assert_array_equal(got["leader"], ref["leader"])
    np.testing.assert_array_equal(got["leader_lat"], ref["leader_lat"])
    for q in fq:
        np.testing.assert_array_equal(
            got[f"leader_lat_{q}"],
            _ref_fpaxos(lat, subsets, clients, ref["leader"], q))
    cov, per_leader = _ref_cov(lat, subsets, clients, 2)
    assert got["cov"].dtype == np.float32
    assert got["cov"].tobytes() == cov.tobytes()
    # the order matters: numpy's pairwise sum over a contiguous copy
    mean = np.mean(np.ascontiguousarray(per_leader), axis=2)
    std = np.std(np.ascontiguousarray(per_leader), axis=2)
    pairwise = std / np.maximum(mean, 1e-9)
    return int((pairwise != cov).sum())


@pytest.mark.parametrize("planet,n", [
    ("gcp", 3), ("gcp", 5), ("aws", 3), ("aws", 5), ("equidistant", 3),
    ("equidistant", 5), ("random", 3), ("random", 5), ("random_ties", 3),
    ("random_ties", 5),
])
def test_twin_matches_reference_batched_config_stats(planet, n):
    differ = _twin_case(planet, n)
    if planet == "gcp":
        # a summation order other than the reference's shows in the COV
        # plane here, so the equality above holds the order itself
        assert differ > 0


@pytest.mark.slow
@pytest.mark.parametrize("n", [7, 9, 11, 13])
def test_twin_matches_reference_gcp_large_n(n):
    _twin_case("gcp", n)


def test_twin_without_a_leader_and_its_work():
    lat = Planet.new().latency_matrix(sorted(Planet.new().regions()))
    subsets = np.asarray(list(itertools.combinations(range(20), 3)))
    got = batched_config_stats(lat, subsets, np.arange(20), [2],
                               device="cpu")
    ref = rmodel.batched_config_stats(lat.astype(np.float32), subsets,
                                      np.arange(20), [2])
    assert sorted(got) == sorted(ref) == ["lat_2"]
    np.testing.assert_array_equal(got["lat_2"].numpy(), ref["lat_2"])
    t = [torch.as_tensor(lat, dtype=torch.float32),
         torch.as_tensor(subsets, dtype=torch.int32),
         torch.arange(20, dtype=torch.int32)]
    n_bytes, ops = bote_stats.work(*t, [2, 3], 2, [2, 3])
    B = len(subsets)
    assert n_bytes == (20 * 20 * 4 + B * 3 * 4 + 20 * 4
                       + 4 * 4 * B * 20 + 8 * B + 4 * B * 3)
    assert ops > 0
    ms, by = bote_stats.bound(*t, [2, 3], 2, [2, 3])
    assert by == "bytes" and ms > 0


def _ranked(res):
    return {n: [(c.score, c.config, c.means) for c in v]
            for n, v in res.items()}


RANK_CASES = {
    "f1": dict(min_mean_fpaxos_improv=float("-inf"),
               min_fairness_fpaxos_improv=float("-inf"), min_n=3,
               max_n=5, ft_metric="f1"),
    "f1f2": dict(min_mean_fpaxos_improv=float("-inf"),
                 min_fairness_fpaxos_improv=float("-inf"), min_n=3,
                 max_n=7, ft_metric="f1f2"),
    "tight": dict(min_mean_fpaxos_improv=30.0,
                  min_fairness_fpaxos_improv=0.0, min_n=3, max_n=5,
                  ft_metric="f1f2"),
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_search_rank_matches_the_reference(case):
    kw = RANK_CASES[case]
    ref = rsearch.Search(RPlanet.new()).rank(rsearch.RankingParams(**kw))
    got = Search(Planet.new()).rank(RankingParams(**kw), device="cpu")
    assert _ranked(got) == _ranked(ref)
    assert sum(len(v) for v in got.values()) > 0


def test_search_rank_servers_clients_and_aws_match_the_reference():
    rp, pp = _planets("aws")
    kw = dict(min_mean_fpaxos_improv=-1000.0,
              min_fairness_fpaxos_improv=-1000.0, min_n=3, max_n=5,
              ft_metric="f1f2")
    ref = rsearch.Search(rp).rank(rsearch.RankingParams(**kw))
    got = Search(pp).rank(RankingParams(**kw), device="cpu")
    assert _ranked(got) == _ranked(ref)
    servers = sorted(RPlanet.new().regions())[:8]
    kw = dict(kw, max_n=5, ft_metric="f1")
    ref = rsearch.Search(RPlanet.new(), servers, servers[:5]).rank(
        rsearch.RankingParams(**kw))
    got = Search(Planet.new(), servers, servers[:5]).rank(
        RankingParams(**kw), device="cpu")
    assert _ranked(got) == _ranked(ref)


@pytest.mark.slow
def test_search_rank_to_13_matches_the_reference():
    kw = dict(min_mean_fpaxos_improv=float("-inf"),
              min_fairness_fpaxos_improv=float("-inf"),
              min_mean_epaxos_improv=0.0, min_n=9, max_n=13,
              ft_metric="f1f2")
    ref = rsearch.Search(RPlanet.new()).rank(rsearch.RankingParams(**kw))
    got = Search(Planet.new()).rank(RankingParams(**kw), device="cpu")
    assert _ranked(got) == _ranked(ref)


def test_host_model_and_compute_stats_match_the_reference():
    planet, rplanet = Planet.new(), RPlanet.new()
    bote, rbote = Bote(planet), rmodel.Bote(rplanet)
    clients = sorted(planet.regions())
    for servers in (["asia-east1", "europe-west2", "us-central1"],
                    ["asia-east1", "asia-northeast1", "europe-west4",
                     "us-east1", "us-west1"]):
        assert bote.leaderless(servers, clients, 2) == rbote.leaderless(
            servers, clients, 2)
        assert bote.leader(servers[1], servers, clients, 2) == rbote.leader(
            servers[1], servers, clients, 2)
        for by in ("mean", "cov", "mdtm"):
            got = bote.best_leader(servers, clients, 2, sort_by=by)
            want = rbote.best_leader(servers, clients, 2, sort_by=by)
            assert got[0] == want[0]
            assert got[1].all_values() == want[1].all_values()
        got = compute_stats(servers, clients, bote)
        want = rsearch.compute_stats(servers, clients, rbote)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].all_values() == want[k].all_values()
    assert [ProtocolModel.epaxos(n) for n in (3, 5, 7, 11, 17)] == [
        rsearch.ProtocolModel.epaxos(n) for n in (3, 5, 7, 11, 17)]


CACHE_KW = dict(min_mean_fpaxos_improv=float("-inf"),
                min_fairness_fpaxos_improv=float("-inf"), min_n=3,
                max_n=5, ft_metric="f1")


def test_search_cache_round_trip(tmp_path, monkeypatch):
    from fantoch_tpu_torch.bote import search as psearch

    servers = Planet.new().regions()[:7]
    search = Search(Planet.new(), servers, servers)
    first = search.rank(RankingParams(**CACHE_KW), device="cpu",
                        cache_path=str(tmp_path))
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("search_")

    def refuse(*a, **kw):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(psearch, "batched_config_stats", refuse)
    again = search.rank(RankingParams(**CACHE_KW), device="cpu",
                        cache_path=str(tmp_path))
    assert _ranked(again) == _ranked(first)
    # a torn cache is recomputed
    monkeypatch.undo()
    path = tmp_path / files[0]
    path.write_bytes(path.read_bytes()[:20])
    torn = search.rank(RankingParams(**CACHE_KW), device="cpu",
                       cache_path=str(tmp_path))
    assert _ranked(torn) == _ranked(first)


def test_reference_cache_recomputed_without_importing_it(tmp_path):
    """The reference writes the same cache file (same key: the same
    ``repr(params)``); the port refuses its class and recomputes, in a
    process that never imports ``fantoch_tpu``."""
    servers = RPlanet.new().regions()[:7]
    rs = rsearch.Search(RPlanet.new(), servers, servers)
    rparams = rsearch.RankingParams(**CACHE_KW)
    want = rs.rank(rparams, cache_path=str(tmp_path))
    assert Search(Planet.new(), servers, servers)._cache_key(
        RankingParams(**CACHE_KW)) == rs._cache_key(rparams)
    (name,) = os.listdir(tmp_path)
    assert b"fantoch_tpu.bote.search" in (tmp_path / name).read_bytes()
    code = (
        "import json, sys\n"
        "from fantoch_tpu_torch.bote import RankingParams, Search\n"
        "from fantoch_tpu_torch.core import Planet\n"
        f"servers = {servers!r}\n"
        "res = Search(Planet.new(), servers, servers).rank(\n"
        f"    RankingParams(**json.loads({json.dumps(CACHE_KW)!r})),\n"
        "    device='cpu',\n"
        f"    cache_path={str(tmp_path)!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('fantoch_tpu', 'jax'))\n"
        "print(json.dumps({'bad': bad, 'ranked': {n: [[c.score, "
        "list(c.config), c.means] for c in v] for n, v in res.items()}}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert got["bad"] == []
    assert got["ranked"] == {str(n): [[c.score, list(c.config), c.means]
                                      for c in v] for n, v in want.items()}
    # the recomputed result replaced the file: the port's class now
    with open(tmp_path / name, "rb") as fh:
        data = fh.read()
    assert b"fantoch_tpu_torch.bote.search" in data
    assert _ranked(pickle.loads(data)) == _ranked(want)


def _cli_out(main, argv):
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except SystemExit as e:
            code = 0 if e.code is None else e.code
    return code, out.getvalue()


@pytest.mark.parametrize("argv", [
    [],
    ["--metric", "f1f2", "--aws", "--top", "5", "--max-n", "5"],
    ["--min-mean-improv", "20", "--min-fairness-improv", "-1",
     "--max-n", "5", "--top", "2"],
])
def test_cli_bote_bytes_match_the_reference(argv):
    code, want = _cli_out(rcli.main, ["--platform", "cpu", "bote", *argv])
    assert code == 0 and want
    code, got = _cli_out(cli.main, ["--device", "cpu", "bote", *argv])
    assert code == 0
    assert got == want


def _candidates_equal(got, want):
    assert [(c.regions, c.score, c.closed_form) for c in got] == [
        (c.regions, c.score, c.closed_form) for c in want]


@pytest.mark.parametrize("rank_by", ["score", "knee"])
def test_validate_dryrun_artifact_matches_the_reference(tmp_path, rank_by):
    rc = rvalidate.frontier_candidates(RPlanet.new(), 3, 2)
    pc = validate.frontier_candidates(Planet.new(), 3, 2, device="cpu")
    _candidates_equal(pc, rc)
    kw = dict(traffic=("flat", "diurnal") if rank_by == "score"
              else ("flat",), dryrun=True, rank_by=rank_by)
    ra, rs = rvalidate.validate_frontier(
        str(tmp_path / "r"), planet=RPlanet.new(), candidates=rc, **kw)
    pa, ps = validate.validate_frontier(
        str(tmp_path / "p"), planet=Planet.new(), candidates=pc, **kw)
    assert pa == ra and ps["done"] and ps["dryrun"]
    validate.check_frontier_artifact(pa)
    assert (tmp_path / "p" / "frontier.json").read_bytes() == (
        tmp_path / "r" / "frontier.json").read_bytes()
    bad = json.loads(json.dumps(pa))
    del bad["candidates"][0]["closed_form"]["af1"]["p99"]
    with pytest.raises(AssertionError):
        validate.check_frontier_artifact(bad)


MEASURED = dict(protocols=("fpaxos",), fs=(1,), conflicts=(100,),
                traffic=("flat",), commands=2, batch_lanes=4,
                segment_steps=512)


def test_validate_measured_artifact_matches_the_reference(tmp_path):
    rc = rvalidate.frontier_candidates(RPlanet.new(), 3, 1)
    ra, rs = rvalidate.validate_frontier(
        str(tmp_path / "r"), planet=RPlanet.new(), candidates=rc, **MEASURED)
    assert rs["done"]
    pc = validate.frontier_candidates(Planet.new(), 3, 1, device="cpu")
    pa, ps = validate.validate_frontier(
        str(tmp_path / "p"), planet=Planet.new(), candidates=pc,
        device="cpu", **MEASURED)
    assert ps["done"] and pa == ra
    for name in ("frontier.json", "results.jsonl", "campaign.json"):
        assert (tmp_path / "p" / name).read_bytes() == (
            tmp_path / "r" / name).read_bytes(), name
    stats = pa["candidates"][0]["measured"]["fpaxos"]["f1"]["flat"]["100"]
    assert stats["count"] == 2 * 3 and stats["errors"] == 0


def test_cli_bote_validate_exits(tmp_path):
    d = str(tmp_path / "v")
    base = ["--device", "cpu", "bote", "--validate", "--dir", d, "--n", "3",
            "--top", "1"]
    code, out = _cli_out(cli.main, base + ["--dryrun", "--out",
                                          str(tmp_path / "f.json")])
    assert code == 0 and json.loads(out)["dryrun"]
    # interrupted by the budget after its first unit (two units: one per
    # conflict), then resumed
    grid = ["--protocols", "fpaxos", "--conflicts", "0,100", "--commands",
            "2", "--batch-lanes", "1", "--segment-steps", "512"]
    code, out = _cli_out(cli.main, base + grid + ["--budget-s", "0"])
    assert code == 75 and not json.loads(out)["done"]
    code, out = _cli_out(cli.main, base + grid + ["--resume"])
    assert code == 0 and json.loads(out)["done"]
    validate.check_frontier_artifact(
        json.loads((tmp_path / "v" / "frontier.json").read_text()))
    # a different grid in the same directory is refused
    code, _out = _cli_out(cli.main, base + ["--protocols", "atlas"])
    assert code == 2
    with pytest.raises(SystemExit, match="unknown protocol"):
        cli.main(base + ["--protocols", "paxos"])


@pytest.mark.slow
def test_validate_measured_defaults_match_the_reference(tmp_path):
    """``bote --validate``'s default protocols (Atlas and FPaxos) at
    n = 3, two candidates, conflicts 0 and 100."""
    kw = dict(commands=3, batch_lanes=8, segment_steps=512)
    rc = rvalidate.frontier_candidates(RPlanet.new(), 3, 2)
    ra, _ = rvalidate.validate_frontier(
        str(tmp_path / "r"), planet=RPlanet.new(), candidates=rc, **kw)
    pc = validate.frontier_candidates(Planet.new(), 3, 2, device="cpu")
    pa, _ = validate.validate_frontier(
        str(tmp_path / "p"), planet=Planet.new(), candidates=pc,
        device="cpu", **kw)
    assert (tmp_path / "p" / "frontier.json").read_bytes() == (
        tmp_path / "r" / "frontier.json").read_bytes()


def test_no_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lat = Planet.new().latency_matrix(sorted(Planet.new().regions()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched_config_stats(lat, [[0, 1, 2]], [0, 1], [2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Search(Planet.new()).rank(RankingParams(**CACHE_KW))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate.frontier_candidates(Planet.new(), 3, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bote", "--max-n", "3"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bote", "--validate", "--dir", str(tmp_path), "--n", "3",
                  "--dryrun"])


def test_kernel_wrapper_refuses_bad_cuda_arguments():
    """On a CUDA tensor K15's wrapper launches or raises; its checks run
    before any launch (a meta tensor stands in for the card)."""
    meta = dict(device="meta")
    lat = torch.empty((20, 20), dtype=torch.float32, **meta)
    sub = torch.empty((4, 3), dtype=torch.int32, **meta)
    cli_t = torch.empty((20,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="dtype"):
        bote_stats.bote_stats(lat, sub.long(), cli_t, [2], 2, [2])
    big = torch.empty((120, 120), dtype=torch.float32, **meta)
    with pytest.raises(ValueError, match="shared memory"):
        bote_stats.bote_stats(big, sub, cli_t, [2], 2, [2])
    with pytest.raises(ValueError, match="quorum sizes"):
        bote_stats.bote_stats(lat, sub, cli_t, [4], 2, [2])
    with pytest.raises(ValueError, match="exceed"):
        bote_stats.bote_stats(lat, sub, cli_t, [1] * 9, 2, [2])
