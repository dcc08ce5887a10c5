"""`.bkwig`, the binary kwig of per-base tracks (`-o x.bkwig`): k, the
path index, then 12 bytes (u32 cov, right, left) a segment base."""

from __future__ import annotations

import struct

import numpy as np

from kqbench.reference.validate import paths_of

CHECK = "bkwig_values_off"
LIMIT = 0
TRACKS = True


def expected(table, records, score) -> bytes:
    """k, the path index (per path its name and, per segment, absolute
    position, length and 1), then the score's tracks."""
    parts = [struct.pack("<B", table.k)]
    paths = paths_of(records)
    parts.append(struct.pack("<I", len(paths)))
    for path in paths:
        name = path.name.encode()
        parts.append(struct.pack("<H", len(name)) + name)
        parts.append(struct.pack("<I", len(path.segments)))
        for pos, seq in path.segments:
            parts.append(struct.pack("<QQB", pos, len(seq), 1))
    for trk in score.tracks:
        parts.append(trk.astype("<u4").tobytes())
    return b"".join(parts)


def _index_len(b: bytes) -> int:
    """Bytes of a `.bkwig`'s k and path index: per path a u16 name
    length, the name, a u32 segment count and 17 bytes a segment."""
    at = 5
    for _ in range(struct.unpack_from("<I", b, 1)[0]):
        at += 2 + struct.unpack_from("<H", b, at)[0]
        at += 4 + 17 * struct.unpack_from("<I", b, at)[0]
    return at


def values_off(got: bytes, want: bytes) -> int:
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
