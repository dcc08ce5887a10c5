"""The comparison that decides `correct`: a job's stdout and files
against the reference's, field by field and value by value.

Each check is a count of fields or values that differ.  A stdout part's
check is `<part>_fields_off`, limit 0; a file's is its kind's
(kqbench/kinds/).  kreeq's outputs are exact, and any difference is a
wrong answer.
"""

from __future__ import annotations

from . import kinds

FIELDS_LIMIT = 0


def limits(traffic: dict) -> dict:
    """{check: limit} of a traffic's stdout parts, then of its files'
    kinds."""
    out = {f"{p}_fields_off": FIELDS_LIMIT for p in traffic["stdout"]}
    for kind in traffic["files"].values():
        mod = kinds.find(kind)
        out[mod.CHECK] = mod.LIMIT
    return out


def _fields_off(got: list, want: list) -> int:
    """Whitespace-separated fields of `got` lines that differ from
    `want`'s, a missing or extra field counting once."""
    g = " ".join(got).split()
    w = " ".join(want).split()
    return sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))


def stdout_checks(text: str, parts: dict) -> dict:
    """{<part>_fields_off: n} of a job's stdout against the reference's
    parts, in order; the job's lines are cut where the reference's
    parts end, and lines beyond the last part count with it."""
    lines = text.splitlines()
    out, at = {}, 0
    names = list(parts)
    for i, name in enumerate(names):
        want = parts[name].splitlines()
        got = lines[at:] if i == len(names) - 1 else lines[at:at + len(want)]
        out[f"{name}_fields_off"] = _fields_off(got, want)
        at += len(want)
    return out
