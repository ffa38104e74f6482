"""The kernel build (``fantoch_tpu_torch/kernels/build.py``) when two
processes build at once, as ``fleet --workers`` may start them on a tree
that has not been built: a stub compiler stands in for ``nvcc`` (this
machine has none), slow enough that the two builds overlap. Both return
the same complete library, and no object, log or library file of either
build is left half-written or behind."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# a stand-in for nvcc: `-c SRC -o OBJ` writes the source's name into OBJ
# (slowly, in two halves), `-shared -o LIB OBJ...` concatenates the objects
STUB = textwrap.dedent('''\
    import sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    if "-c" in args:
        src = args[args.index("-c") + 1]
        with open(out, "w") as fh:
            fh.write("obj:")
            fh.flush()
            time.sleep(0.3)
            fh.write(src.rsplit("/", 1)[-1] + "\\n")
    else:
        objs = [a for a in args if a.endswith(".o")]
        with open(out, "w") as fh:
            for o in objs:
                time.sleep(0.02)
                fh.write(open(o).read())
    ''')

BUILDER = textwrap.dedent('''\
    import sys
    from pathlib import Path
    from fantoch_tpu_torch.kernels import build
    build.BUILD_ROOT = Path(sys.argv[1])
    build._nvcc = lambda: sys.argv[2]
    print(build.build())
    ''')


def test_two_processes_build_one_complete_library(tmp_path):
    stub = tmp_path / "nvcc"
    stub.write_text(f"#!{sys.executable}\n" + STUB)
    stub.chmod(0o755)
    root = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILDER, str(root), str(stub)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _err in outs}
    assert len(paths) == 1
    lib = Path(paths.pop())
    sources = sorted(p.name for p in
                     (ROOT / "fantoch_tpu_torch/kernels/csrc").glob("*.cu"))
    assert "bote_stats.cu" in sources
    assert lib.read_text() == "".join(f"obj:{s}\n" for s in sources)
    # the digest's directory holds the library and the log, nothing else
    assert sorted(os.listdir(lib.parent)) == ["libfantoch_kernels.so",
                                              "nvcc.log"]
    assert "== bote_stats.cu" in (lib.parent / "nvcc.log").read_text()
    # a later build finds the library and compiles nothing
    again = subprocess.run(
        [sys.executable, "-c", BUILDER, str(root), "/nonexistent/nvcc"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert again.returncode == 0, again.stderr
    assert again.stdout.strip() == str(lib)
