"""PyTorch port, runner tooling and warmup on the CPU: the golden-corpus
harness (cli/validate_runner.py), the corpus generator
(cli/generate_tests.py) and `kreeq warmup` (cli/warmup.py) against the
JAX package's, on a generated corpus with every name the generator's
matrix reads (chip_smoke.write_corpus; DBs and tracks written by the
JAX CLI): the same .tst bytes, the same runner stdout and exit codes,
also for failing, unreadable, external-golden and nested tests."""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 10 validated inputs x 5, union, 12 subgraph, 2 decompressor, the VCF
N_TST = 66
WARMUP_LINE = (r"warmup: \d+ programs compiled/cached in \d+\.\ds "
               r"\(k={k}, chunk=16384, window=4096\)")


def _quiet(run):
    def cli(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            assert run(argv) == 0
    return cli


def _generate(module, root, answer):
    """module.main() in `root` with `answer` at its prompt: (stdout,
    exit code)."""
    cwd = os.getcwd()
    buf = io.StringIO()
    stdin = sys.stdin
    os.chdir(root)
    sys.stdin = io.StringIO(answer + "\n")
    rc = 0
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    except SystemExit as e:
        rc = e.code
    finally:
        sys.stdin = stdin
        os.chdir(cwd)
    return buf.getvalue(), rc


def _runner(module, args):
    """module.main(args): (stdout, exit code)."""
    buf = io.StringIO()
    rc = None
    with contextlib.redirect_stdout(buf):
        try:
            module.main(args)
        except SystemExit as e:
            rc = e.code
    return buf.getvalue(), rc


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("KREEQ_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(corpus root, the JAX generator's stdout): the JAX goldens in
    validateFiles/."""
    import chip_smoke
    from kreeq_tpu.cli import generate_tests
    from kreeq_tpu.cli.main import run

    root = str(tmp_path_factory.mktemp("corpus") / "c")
    chip_smoke.write_corpus(root, 7, _quiet(run))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KREEQ_TPU_PLATFORM", "cpu")
        out, rc = _generate(generate_tests, root, "Y")
    assert rc == 0
    assert len(os.listdir(os.path.join(root, "validateFiles"))) == N_TST
    return root, out


def test_port_runner_passes_jax_corpus(corpus):
    """Every .tst of the JAX generator passes in the port's runner, with
    the JAX runner's stdout and exit code; and again in the same
    process."""
    from kreeq_tpu.cli import validate_runner as jax_runner
    from kreeq_tpu_torch.cli import validate_runner

    root, _gen = corpus
    vf = os.path.join(root, "validateFiles")
    want = _runner(jax_runner, [vf])
    lines = want[0].splitlines()
    assert want[1] == 0 and len(lines) == N_TST
    assert all(line.startswith("\033[0;32mPASS\033[0m ") for line in lines)
    assert _runner(validate_runner, [vf]) == want
    assert _runner(validate_runner, [vf]) == want


def test_generate_tests_matches_jax(corpus, tmp_path):
    """The port's generator writes the JAX generator's .tst bytes under
    the same names and prints the same progress lines."""
    from kreeq_tpu_torch.cli import generate_tests

    root, jax_out = corpus
    copy = str(tmp_path / "c")
    shutil.copytree(root, copy)
    out, rc = _generate(generate_tests, copy, "Y")
    assert rc == 0 and out == jax_out
    assert "generating: validateFiles/test.65.tst" in out
    names = sorted(os.listdir(os.path.join(root, "validateFiles")))
    assert sorted(os.listdir(os.path.join(copy, "validateFiles"))) == names
    for name in names:
        with open(os.path.join(root, "validateFiles", name), "rb") as w, \
                open(os.path.join(copy, "validateFiles", name), "rb") as g:
            assert g.read() == w.read(), name


def test_generate_tests_cancel_matches_jax(corpus, tmp_path):
    """Answered N, both generators cancel alike and delete nothing."""
    from kreeq_tpu.cli import generate_tests as jax_generate
    from kreeq_tpu_torch.cli import generate_tests

    root, _gen = corpus
    copy = str(tmp_path / "c")
    shutil.copytree(root, copy)
    want = _generate(jax_generate, copy, "N")
    assert want[1] == 0 and want[0].endswith("validate generation "
                                             "cancelled\n")
    assert _generate(generate_tests, copy, "N") == want
    assert len(os.listdir(os.path.join(copy, "validateFiles"))) == N_TST


def _tst(path, cmd, golden, line2="embedded"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(f"{cmd}\n{line2}\n{golden}")


def _golden(root, n):
    with open(os.path.join(root, "validateFiles", f"test.{n}.tst")) as fh:
        lines = fh.read().split("\n")
    return lines[0], "\n".join(lines[2:])


def _case(kind, root, case):
    """The runner's arguments for mutation case `kind`, its files under
    `case` (inside the corpus root, so commands find testFiles/)."""
    cmd, golden = _golden(root, 0)
    if kind == "changed_line":
        lines = golden.split("\n")
        lines[1] = lines[1].replace("kmers: ", "kmers: 1")
        _tst(f"{case}/test.0.tst", cmd, "\n".join(lines))
        _tst(f"{case}/test.1.tst", *_golden(root, 50))
        return [case]
    if kind == "nonzero_exit":
        _tst(f"{case}/a.tst", "kreeq validate -f testFiles/none.fasta", "")
        _tst(f"{case}/b.tst", "kreeq-nothing run", "")
        _tst(f"{case}/c.tst", "kreeq nomode -r x", "")
        return [case]
    if kind == "unreadable":
        os.makedirs(f"{case}/dir.tst")
        return [f"{case}/missing.tst", f"{case}/dir.tst", f"{root}/"
                "validateFiles/test.50.tst"]
    if kind == "external_golden":
        with open(f"{root}/golden0.txt", "w") as fh:
            fh.write(golden)
        _tst(f"{case}/ok.tst", cmd, "", f"{root}/golden0.txt")
        _tst(f"{case}/wrong.tst", *_golden(root, 1)[:1], "",
             f"{root}/golden0.txt")
        _tst(f"{case}/absent.tst", cmd, golden, f"{root}/absent.txt")
        return [case]
    if kind == "nested":
        _tst(f"{case}/a/b/test.2.tst", *_golden(root, 2))
        _tst(f"{case}/a/test.63.tst", *_golden(root, 63))
        for name in ("a/notes.txt", "a/b/test.2.tst.bak", "a/b/tst"):
            with open(f"{case}/{name}", "w") as fh:
                fh.write("kreeq nomode\n")
        return [case, f"{case}/a/test.63.tst"]
    if kind == "dash_c":
        _tst(f"{case}/test.0.tst", cmd, golden)
        return ["-c", case, "-c"]
    if kind == "no_arguments":
        return []
    assert kind == "only_dash_c"
    return ["-c"]


@pytest.mark.parametrize("kind", [
    "changed_line", "nonzero_exit", "unreadable", "external_golden",
    "nested", "dash_c", "no_arguments", "only_dash_c"])
def test_runner_cases_match_jax(corpus, kind):
    """Both runners give the same stdout and exit code on each case."""
    from kreeq_tpu.cli import validate_runner as jax_runner
    from kreeq_tpu_torch.cli import validate_runner

    root, _gen = corpus
    args = _case(kind, root, f"{root}/case_{kind}")
    want = _runner(jax_runner, args)
    assert _runner(validate_runner, args) == want
    expect_rc = {"changed_line": 1, "nonzero_exit": 1, "unreadable": 1,
                 "external_golden": 1}.get(kind, 0)
    assert want[1] == expect_rc
    if kind == "changed_line":
        assert "\033[0;31mFAIL\033[0m " in want[0]
        assert "    expected: Total kmers: 1" in want[0]
    if kind == "nonzero_exit":
        assert want[0].count("runtime error\n") == 2
        assert "runtime error: unknown executable kreeq-nothing" in want[0]
    if kind == "unreadable":
        assert want[0].count("couldn't open test file") == 2
    if kind in ("no_arguments", "only_dash_c"):
        assert want[0] == "kreeq-validate <path to test folder and/or " \
            "files>\n"


def test_known_diff_pin_is_jax_pin():
    from kreeq_tpu.cli import validate_runner as jax_runner
    from kreeq_tpu_torch.cli import validate_runner

    assert validate_runner.KNOWN_DIFF == jax_runner.KNOWN_DIFF


@pytest.mark.parametrize("k", [21, 31])
def test_warmup_small(capsys, k):
    """`kreeq warmup --small` runs the plain versions on the CPU and
    ends with the JAX line format; each program's tick goes to
    stderr."""
    from kreeq_tpu.cli.main import run as jax_run
    from kreeq_tpu_torch.cli.main import run

    opts = [] if k == 21 else ["-k", str(k)]
    assert run(["kreeq", "warmup", *opts, "--small"]) == 0
    out, err = capsys.readouterr()
    line = re.compile(WARMUP_LINE.format(k=k))
    assert line.fullmatch(out.splitlines()[-1])
    assert "warmup: count @16384" in err and "warmup: probe-qv" in err
    if k == 21:
        assert jax_run(["kreeq", "warmup", "--small"]) == 0
        assert line.fullmatch(capsys.readouterr().out.splitlines()[-1])


def test_warmup_unknown_option(capsys):
    from kreeq_tpu.cli.main import run as jax_run
    from kreeq_tpu_torch.cli.main import run

    argv = ["kreeq", "warmup", "--small", "--bogus"]
    assert jax_run(argv) == 1
    want = capsys.readouterr()
    assert want.err == "warmup: unknown option --bogus\n"
    assert run(argv) == 1
    assert capsys.readouterr() == want


_FRESH = """
import sys
from kreeq_tpu_torch.cli import generate_tests, validate_runner, warmup
try:
    validate_runner.main([sys.argv[1]])
except SystemExit as e:
    rc = e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kreeq_tpu"))
print("rc", rc, "bad", bad)
"""


def test_fresh_interpreter_imports_no_jax(corpus):
    """The three modules and a whole runner pass import neither jax nor
    the JAX package."""
    root, _gen = corpus
    env = dict(os.environ, KREEQ_TPU_PLATFORM="cpu")
    res = subprocess.run([sys.executable, "-c", _FRESH,
                          os.path.join(root, "validateFiles")], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("PASS") == N_TST
    assert res.stdout.splitlines()[-1] == "rc 0 bad []"


def test_runner_without_card_fails(corpus, monkeypatch):
    """No KREEQ_TPU_PLATFORM and no card: every test FAILs with a
    runtime error, the decompressor's too; none passes on the CPU."""
    from kreeq_tpu_torch import device
    from kreeq_tpu_torch.cli import validate_runner

    root, _gen = corpus
    monkeypatch.delenv("KREEQ_TPU_PLATFORM")
    monkeypatch.setattr(device.torch.cuda, "is_available", lambda: False)
    vf = os.path.join(root, "validateFiles")
    args = [f"{vf}/test.{n}.tst" for n in (0, 50, 51, 63, 64, 65)]
    out, rc = _runner(validate_runner, args)
    lines = out.splitlines()
    assert rc == 1 and len(lines) == len(args)
    assert all(line.startswith("\033[0;31mFAIL\033[0m ")
               and line.endswith("runtime error: no CUDA device is "
                                 "available; set KREEQ_TPU_PLATFORM=cpu "
                                 "to run the plain PyTorch versions on "
                                 "the CPU") for line in lines)
