"""The comparison that decides `correct`: a job's stdout and files
against the reference's, field by field and value by value.

Each check is a count of fields or values that differ, with the limit
0: kreeq's outputs are exact, and any difference is a wrong answer.
"""

from __future__ import annotations

import struct

import numpy as np

LIMITS = {"summary_fields_off": 0, "qv_fields_off": 0,
          "bkwig_values_off": 0}


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


def _index_len(b: bytes) -> int:
    """Bytes of a `.bkwig`'s k and path index: per path a u16 name
    length, the name, a u32 segment count and 17 bytes a segment."""
    at = 5
    for _ in range(struct.unpack_from("<I", b, 1)[0]):
        at += 2 + struct.unpack_from("<H", b, at)[0]
        at += 4 + 17 * struct.unpack_from("<I", b, at)[0]
    return at


def bkwig_values_off(got: bytes, want: bytes) -> int:
    """Values of a `.bkwig` that differ from the reference's: each byte
    of k and the index, then each u32 of the tracks; a missing or extra
    value counts once."""
    head = _index_len(want)
    g = np.frombuffer(got, np.uint8)
    w = np.frombuffer(want, np.uint8)
    n = min(head, len(g))
    off = int((g[:n] != w[:n]).sum()) + head - n
    gt = g[n:n + (len(g) - n) // 4 * 4].view("<u4")
    wt = w[head:].view("<u4")
    m = min(len(gt), len(wt))
    return off + int((gt[:m] != wt[:m]).sum()) + abs(len(gt) - len(wt))


FILE_CHECKS = {"bkwig": ("bkwig_values_off", bkwig_values_off)}
