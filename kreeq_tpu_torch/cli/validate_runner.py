"""kreeq-torch-validate: golden-output test harness of the PyTorch port
(reference: src/validate.cpp; counterpart of
kreeq_tpu/cli/validate_runner.py, whose output bytes and exit codes it
keeps).

Walks directories for `*.tst` files, executes line 1 as a command
(mapped onto the port's CLIs, in-process), and line-diffs stdout
against the embedded golden (or an external file named on line 2).
Exit code is non-zero if any test fails.

Unlike the JAX harness, which forces the CPU, this one leaves the
device to KREEQ_TPU_PLATFORM (device.py): unset runs every command on
the card, and fails each test where there is none; "cpu" runs the
plain versions.  Every command resolves the device first, the
host-only decompressor's too, so a corpus never passes on the CPU
unless the CPU was asked for.
"""

from __future__ import annotations

import contextlib
import io
import os
import shlex
import sys
from typing import List, Set

GREEN = "\033[0;32m"
RED = "\033[0;31m"
RESET = "\033[0m"

# Documented behavioral differences, pinned EXACTLY (the JAX harness's
# pin, copied): for the named .tst, the given 0-based golden line may
# instead equal the pinned text.  Anything else — including drift from
# the pinned text itself — still FAILs.
# test.50 line 21: the snapshot's variants.cpp yields a COM variant for
# sequence15's first homopolymer deletion where the golden (generated
# by an earlier reference build) has the normalized DEL row; see
# KNOWN_GAPS.md and tools/adjudicate_test50/.
KNOWN_DIFF = {
    "test.50.tst": {
        21: ("sequence15\t47\t.\tTGCATGCATCGATCGATCG\t"
             "GCATGCATCGATCGATCGA\t0\tPASS\t.\tGT:GQ\t1/1:0"),
    },
}


def get_file_ext(name: str) -> str:
    if "." not in name:
        return ""
    return name.rsplit(".", 1)[1]


def collect(paths: List[str]) -> Set[str]:
    out: Set[str] = set()
    for path in paths:
        if get_file_ext(path) == "tst":
            out.add(path)
        elif os.path.isdir(path):
            for root, _dirs, files in os.walk(path):
                for f in files:
                    if get_file_ext(f) == "tst":
                        out.add(os.path.join(root, f))
    return out


def run_command(cmd: str) -> str:
    from ..device import resolve_device

    argv = shlex.split(cmd)
    resolve_device()  # no card and no KREEQ_TPU_PLATFORM=cpu: raise
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if argv[0] == "kreeq":
            from .main import run

            run(argv)
        elif argv[0] == "kreeq-decompressor":
            from .decompressor import run

            run(argv)
        else:
            raise RuntimeError(f"unknown executable {argv[0]}")
    return buf.getvalue()


def golden(lines: List[str]) -> str:
    """The expected stdout of a .tst's lines: the file that line 2
    names, where it names one that exists, else the lines after it."""
    if len(lines) > 1 and lines[1].strip() != "embedded" \
            and os.path.exists(lines[1].strip()):
        with open(lines[1].strip()) as fh:
            return fh.read()
    return "\n".join(lines[2:])


def compared(tst: str, actual: str, expected: str):
    """(got, want): the lines of a .tst's stdout and of its golden, the
    KNOWN_DIFF pin of that .tst applied to the golden's."""
    got = actual.rstrip("\n").splitlines()
    want = expected.rstrip("\n").splitlines()
    pinned = KNOWN_DIFF.get(os.path.basename(tst), {})
    if pinned and len(got) == len(want):
        want = [pinned[i] if i in pinned else w for i, w in enumerate(want)]
    return got, want


def main(argv: List[str] = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    argv = [a for a in argv if a != "-c"]
    if not argv:
        print("kreeq-validate <path to test folder and/or files>")
        sys.exit(0)

    ok = True
    for tst in sorted(collect(argv)):
        try:
            with open(tst) as fh:
                lines = fh.read().splitlines()
        except OSError:
            print(f"{RED}FAIL{RESET} {tst} couldn't open test file")
            ok = False
            continue
        cmd = lines[0].strip()
        # test commands use fixture paths relative to the corpus root
        # (the ancestor of the .tst holding testFiles/), as the
        # reference harness does when run from its repo root
        root = os.path.dirname(os.path.abspath(tst))
        while root != os.path.dirname(root) and not os.path.isdir(
                os.path.join(root, "testFiles")):
            root = os.path.dirname(root)
        prev_cwd = os.getcwd()
        if os.path.isdir(os.path.join(root, "testFiles")):
            os.chdir(root)
        try:
            actual = run_command(cmd)
        except SystemExit as e:
            if e.code not in (0, None):
                print(f"{RED}FAIL{RESET} {tst} runtime error")
                ok = False
                continue
            actual = ""
        except Exception as e:  # noqa: BLE001
            print(f"{RED}FAIL{RESET} {tst} runtime error: {e}")
            ok = False
            continue
        finally:
            os.chdir(prev_cwd)
        got, want = compared(tst, actual, golden(lines))
        if got != want:
            print(f"{RED}FAIL{RESET} {tst} expected output did not match "
                  "actual output")
            for i in range(max(len(got), len(want))):
                g = got[i] if i < len(got) else ""
                w = want[i] if i < len(want) else ""
                if g != w:
                    print(f"    expected: {w}\n      actual: {g}")
            ok = False
        else:
            print(f"{GREEN}PASS{RESET} {tst}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
