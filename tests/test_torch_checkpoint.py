"""Sweep checkpoints through the port on the CPU
(``engine/checkpoint.py``, ``parallel/sweep.py run_sweep(checkpoint=)``,
``parallel/pipeline.py CheckpointBuffer``), after the reference's
``tests/test_checkpoint.py`` and ``tests/test_hetero.py``:

- an artifact's round trip, and the refusals by name: a tampered
  signature field, a truncated payload, an unreadable manifest, other
  specs (``ctx``), an artifact of the reference (``kind``; the
  reference's loader refuses the port's the same way), and a resume
  across a native and a mixed batch, both ways (``skeleton``);
- a checkpointed sweep of more than one batch is refused;
- a run stopped after its first window (``stop_after_segments``) and
  resumed gives byte-identical ``to_json()`` to an uninterrupted run,
  on Basic, Tempo, monitored Tempo (whose monitors reduce once, after
  the last window; in the slow tier) and a mixed batch with
  partial-replication lanes;
  the resumed run counts only its own steps, and the artifact is
  discarded once the results exist (kept with ``keep``; saved every
  other boundary with ``every=2``; ignored with ``resume=False``).
  The uninterrupted runs are pinned to the reference elsewhere, on
  these very lanes: Basic and Tempo (a fault-free and a crash lane) are
  ``test_torch_sweep_out.py``'s grids, whose results are the
  reference's byte for byte; monitored Tempo is
  ``test_torch_monitor_protocols.py::test_monitored_batch_equals_reference``'s
  batch, and the mixed batch
  ``test_torch_hetero_partial.py::test_mixed_partial_batch_equals_the_reference``'s;
- the wall-clock budget's stop, and the flush on SIGTERM (a stop at the
  next boundary; a signal during the last window is re-delivered once
  the old handler is back).

On the CPU the device loop's plain twin runs the windows; the card's
overlapped save (pinned copies ordered before the next window's
launch) is ``chip_smoke.py``'s phase."""

import glob
import json
import os
import signal

import numpy as np
import pytest
import torch

from fantoch_tpu.engine import checkpoint as rcheckpoint
from fantoch_tpu_torch import cli
from fantoch_tpu_torch.engine import checkpoint as ckpt
from fantoch_tpu_torch.engine.faults import NO_FAULTS
from fantoch_tpu_torch.engine.checkpoint import (
    CheckpointCorruptError, CheckpointMismatchError, CheckpointSpec,
    SweepInterrupted, checkpoint_exists, load_artifact, save_artifact,
)
from fantoch_tpu_torch.parallel import pipeline, sweep
from test_torch_hetero_partial import PORT, _grid
from test_torch_sweep_out import GRIDS
from torch_monitor_lanes import MONITOR_KEYS, lanes as monitor_lanes
from torch_threads import one_torch_thread  # noqa: F401

SEG = 8  # segments short enough that every lane spans several
MAX = 1 << 20


def _blob(results) -> str:
    return json.dumps([r.to_json() for r in results], sort_keys=True)


def _cli(grid, conflicts=None):
    """``(protocol, dims, specs)`` of a grid of ``GRIDS``, its conflict
    rates replaced by ``conflicts`` when given."""
    argv = list(GRIDS[grid])
    if conflicts is not None:
        argv[argv.index("--conflicts") + 1] = conflicts
    return cli.sweep_setup(cli.parse_args(argv))


def _case(name):
    """``(protocol(s), dims, specs, run_sweep kwargs)`` of a case."""
    if name == "mixed-partial":
        protocols, dims, _specs, mixed = _grid(PORT)
        return protocols, dims, mixed, {"hetero": True}
    if name == "tempo-monitored":
        proto, dims, specs = monitor_lanes(False, "tempo")
        return proto, dims, specs, {"monitor_keys": MONITOR_KEYS}
    proto, dims, specs = _cli({"tempo": "tempo-faults"}.get(name, name))
    return proto, dims, specs, {}


def _run(case, **kw):
    proto, dims, specs, extra = case
    return sweep.run_sweep(proto, dims, specs, device="cpu", max_steps=MAX,
                           segment_steps=SEG, scan_window=1,
                           **extra, **kw)


def _resume(case, path):
    """The resumed run, saving no boundary of its own (``every`` past
    its windows): what it resumes from is the test."""
    return _run(case, checkpoint=CheckpointSpec(path=path, every=MAX))


def _interrupt(case, path, **spec_kw):
    with pytest.raises(SweepInterrupted) as e:
        _run(case, checkpoint=CheckpointSpec(path=path, **spec_kw))
    assert checkpoint_exists(path)
    return e.value


# ----------------------------------------------------------------------
# the artifact
# ----------------------------------------------------------------------

def test_artifact_round_trip_and_refusals(tmp_path):
    path = str(tmp_path / "ck")
    arrays = {"state/x": np.arange(5, dtype=np.int32),
              "ctx/y": np.ones((2, 2), np.float32)}
    sig = {"kind": ckpt.CHECKPOINT_KIND, "protocol": "p", "torch": "x"}
    size = save_artifact(path, arrays, sig, {"until": 3})
    loaded, manifest = load_artifact(path, sig)
    assert manifest["meta"]["until"] == 3
    assert manifest["kind"] == "fantoch-tpu-torch-checkpoint"
    payload = glob.glob(os.path.join(path, "payload-*.npz"))
    assert len(payload) == 1 and os.path.getsize(payload[0]) == size
    np.testing.assert_array_equal(loaded["state/x"], arrays["state/x"])
    assert loaded["state/x"].dtype == np.int32
    assert loaded["ctx/y"].dtype == np.float32
    # a re-save replaces the payload and removes the old one
    save_artifact(path, arrays, sig, {"until": 4})
    assert len(glob.glob(os.path.join(path, "payload-*.npz"))) == 1
    # stale: a tampered signature field, named; a field the run does
    # not carry, named too
    with pytest.raises(CheckpointMismatchError, match="protocol"):
        load_artifact(path, dict(sig, protocol="other"))
    with pytest.raises(CheckpointMismatchError, match="skeleton"):
        load_artifact(path, dict(sig, skeleton="abc"))
    # corrupt: a truncated payload fails its recorded sha256
    payload = glob.glob(os.path.join(path, "payload-*.npz"))[0]
    blob = open(payload, "rb").read()
    with open(payload, "wb") as fh:
        fh.write(blob[: len(blob) // 2])
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        load_artifact(path, sig)
    # corrupt: an unreadable manifest
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        fh.write("{not json")
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        load_artifact(path, sig)


def test_reference_and_port_artifacts_refuse_each_other(tmp_path):
    arrays = {"state/x": np.arange(3, dtype=np.int32)}
    ref = str(tmp_path / "ref")
    rcheckpoint.save_artifact(ref, arrays, {"kind": rcheckpoint.
                                            CHECKPOINT_KIND}, {"until": 1})
    with pytest.raises(CheckpointMismatchError, match="kind"):
        load_artifact(ref)
    port = str(tmp_path / "port")
    ckpt.save_sweep_checkpoint(port, state={"x": arrays["state/x"]},
                               ctx_digest=ckpt.ctx_sha256({}),
                               signature={"kind": "k"}, until=1, meta={})
    with pytest.raises(rcheckpoint.CheckpointMismatchError, match="kind"):
        rcheckpoint.load_sweep_checkpoint(port, signature={}, ctx={})


def test_ctx_digest_tells_ctx_trees_apart():
    ctx = {"a": np.arange(6, dtype=np.int32), "b": {"c": np.zeros(2)}}
    digest = ckpt.ctx_sha256(ctx)
    assert digest == ckpt.ctx_sha256(
        {"b": {"c": torch.zeros(2, dtype=torch.float64)},
         "a": torch.arange(6, dtype=torch.int32)})
    others = [
        dict(ctx, a=np.arange(1, 7, dtype=np.int32)),       # a value
        dict(ctx, a=np.arange(6, dtype=np.int64)),          # a dtype
        dict(ctx, a=np.arange(6, dtype=np.int32).reshape(2, 3)),  # a shape
        {"a2": ctx["a"], "b": ctx["b"]},                    # a key
        {"a": ctx["a"]},                                    # a leaf fewer
    ]
    assert len({digest, *map(ckpt.ctx_sha256, others)}) == 1 + len(others)


def test_step_signature_names_the_step_sources():
    proto, dims, _specs = _cli("tempo-faults")
    sig = ckpt.step_signature(proto, dims, reorder=False,
                              faults=NO_FAULTS, monitor_keys=0)
    assert sig["kind"] == "fantoch-tpu-torch-checkpoint"
    assert sig["torch"] == torch.__version__ and sig["skeleton"] == ""
    names = [p.relative_to(ckpt._PKG).as_posix()
             for p in ckpt.step_sources([proto])]
    assert names == sorted(names)
    assert "engine/core.py" in names
    assert "engine/protocols/tempo.py" in names
    assert "kernels/csrc/tempo_handle.cu" in names
    assert "kernels/step_loop.py" in names
    # the partial twin signs its own module and its base's
    partial = _grid(PORT)[0]["tempo@2shards"]
    names = [p.relative_to(ckpt._PKG).as_posix()
             for p in ckpt.step_sources([partial])]
    assert {"engine/protocols/tempo.py",
            "engine/protocols/tempo_partial.py"} <= set(names)
    assert len(sig["step_source_sha256"]) == 64


# ----------------------------------------------------------------------
# bit-exact resume
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "basic", "tempo",
    # two whole runs of 516 monitored steps: the slow tier's
    pytest.param("tempo-monitored", marks=pytest.mark.slow),
    "mixed-partial"])
def test_resume_bit_exact(tmp_path, name):
    case = _case(name)
    control = _run(case)
    ctrl_stats = dict(sweep.LAST_STATS)
    path = str(tmp_path / "ck")
    stop = _interrupt(case, path, stop_after_segments=1)
    assert (stop.reason, stop.until) == ("segment-limit", SEG)
    assert sweep.LAST_STATS["checkpoint_saves"] == 1
    assert sweep.LAST_STATS["checkpoint_bytes"] > 0
    resumed = _resume(case, path)
    assert _blob(resumed) == _blob(control)
    assert not checkpoint_exists(path), "discarded once results exist"
    stats = sweep.LAST_STATS
    assert stats["resume_until"] == SEG
    # the resumed run counts its own steps only (one a body here)
    assert stats["batch_steps"] == ctrl_stats["batch_steps"] - SEG
    assert stats["overshoot_steps"] == ctrl_stats["overshoot_steps"]
    if name == "tempo-monitored":
        assert any(r.violation for r in control)


def test_keep_leaves_the_last_boundary(tmp_path):
    case = _case("basic")
    path = str(tmp_path / "ck")
    control = _run(case, checkpoint=CheckpointSpec(path=path, keep=True))
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["meta"]["lanes"] == 4
    assert manifest["meta"]["until"] >= max(r.steps for r in control) - SEG
    # a run resumed from it runs the last window again
    again = _run(case, checkpoint=CheckpointSpec(path=path, keep=True))
    assert _blob(again) == _blob(control)


def test_every_other_boundary_and_no_resume(tmp_path):
    case = _case("basic")
    control = _run(case)
    path = str(tmp_path / "ck")
    every = _run(case, checkpoint=CheckpointSpec(path=path, every=2,
                                                 keep=True))
    saves = sweep.LAST_STATS["checkpoint_saves"]
    windows = sweep.LAST_STATS["device_calls"]
    assert _blob(every) == _blob(control)
    assert 1 <= saves <= windows // 2
    until = json.load(open(os.path.join(path, "manifest.json")))["meta"][
        "until"]
    assert until % (2 * SEG) == 0
    # resume=False runs from the start past a valid artifact
    fresh = _run(case, checkpoint=CheckpointSpec(path=path, resume=False))
    assert _blob(fresh) == _blob(control)
    assert sweep.LAST_STATS["resume_until"] == 0
    assert not checkpoint_exists(path)


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------

def test_stale_and_other_spec_checkpoints_refused(tmp_path):
    case = _case("basic")
    path = str(tmp_path / "ck")
    _interrupt(case, path, stop_after_segments=1)
    proto, dims, other = _cli("basic", conflicts="0,50")
    with pytest.raises(CheckpointMismatchError, match="ctx"):
        _run((proto, dims, other, {}), checkpoint=CheckpointSpec(path=path))
    with pytest.raises(CheckpointMismatchError, match="segment_steps"):
        sweep.run_sweep(*case[:3], device="cpu", max_steps=MAX,
                        segment_steps=2 * SEG, scan_window=1,
                        checkpoint=CheckpointSpec(path=path))
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["signature"]["step_source_sha256"] = "0" * 64
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)
    with pytest.raises(CheckpointMismatchError, match="step_source_sha256"):
        _run(case, checkpoint=CheckpointSpec(path=path))
    with open(mpath, "w") as fh:
        fh.write("{")
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        _run(case, checkpoint=CheckpointSpec(path=path))


def test_native_and_mixed_resumes_refused_by_skeleton(tmp_path):
    proto, dims, specs = _cli("tempo-faults")
    native = (proto, dims, specs, {})
    mixed = ({"tempo": proto}, {"tempo": dims},
             [("tempo", s) for s in specs], {"hetero": True})
    for src, dst, name in ((native, mixed, "n2m"), (mixed, native, "m2n")):
        path = str(tmp_path / name)
        _interrupt(src, path, stop_after_segments=1)
        with pytest.raises(CheckpointMismatchError, match="skeleton"):
            _run(dst, checkpoint=CheckpointSpec(path=path))


def test_multi_batch_checkpoint_refused(tmp_path):
    proto, dims, specs = _cli("basic")
    with pytest.raises(ValueError, match="item 14"):
        sweep.run_sweep(proto, dims, specs, batch_lanes=2, device="cpu",
                        checkpoint=str(tmp_path / "ck"))
    assert not checkpoint_exists(str(tmp_path / "ck"))


# ----------------------------------------------------------------------
# stops: the budget and a signal
# ----------------------------------------------------------------------

def test_budget_stop_and_resume(tmp_path):
    case = _case("basic")
    control = _run(case)
    path = str(tmp_path / "ck")
    stop = _interrupt(case, path, budget_s=0.0)
    assert (stop.reason, stop.until) == ("budget exhausted", SEG)
    resumed = _resume(case, path)
    assert _blob(resumed) == _blob(control)


def _signal_at_push(monkeypatch, at: int):
    """SIGTERM to this process when the ``at``-th window is pushed."""
    push = pipeline.SegmentWindow.push
    seen = {"n": 0}

    def signalling(self, any_alive):
        seen["n"] += 1
        if seen["n"] == at:
            os.kill(os.getpid(), signal.SIGTERM)
        return push(self, any_alive)

    monkeypatch.setattr(pipeline.SegmentWindow, "push", signalling)


def test_sigterm_flushes_and_resumes(tmp_path, monkeypatch):
    case = _case("tempo")
    control = _run(case)
    before = signal.getsignal(signal.SIGTERM)
    path = str(tmp_path / "ck")
    _signal_at_push(monkeypatch, 2)
    stop = _interrupt(case, path)
    assert (stop.reason, stop.until) == (f"signal {int(signal.SIGTERM)}",
                                         2 * SEG)
    assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.undo()
    resumed = _resume(case, path)
    assert _blob(resumed) == _blob(control)


def test_signal_in_the_last_window_is_redelivered(tmp_path, monkeypatch):
    case = _case("basic")
    control = _run(case)
    got = []
    old = signal.signal(signal.SIGTERM, lambda num, _f: got.append(num))
    try:
        _signal_at_push(monkeypatch, 1)
        path = str(tmp_path / "ck")
        # one window covers the whole batch: the signal finds it finished
        res = sweep.run_sweep(*case[:3], device="cpu", max_steps=MAX,
                              segment_steps=4096, scan_window=1,
                              checkpoint=CheckpointSpec(path=path))
    finally:
        signal.signal(signal.SIGTERM, old)
    assert got == [signal.SIGTERM]
    assert _blob(res) == _blob(control)
    assert not checkpoint_exists(path)
