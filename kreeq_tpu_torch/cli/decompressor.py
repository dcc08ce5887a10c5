"""kreeq-decompressor: inflate / random-access lookup of .bkwig tracks.

Host-only counterpart of kreeq_tpu/cli/decompressor.py, with the same
output; run it as `kreeq-torch-decompressor` or `python -m
kreeq_tpu_torch.cli.decompressor`.  Behavioral port of the standalone
reference binary (reference: src/decompressor.cpp), including its
offset-resolution quirk: a lookup
whose span reaches or crosses the end of a path component leaves the
file offset at the start of the data area (reference:
src/decompressor.cpp:140-151 falls through without setting offset).
"""

from __future__ import annotations

import struct
import sys
from typing import Dict, List, Tuple

import numpy as np


class BkwigIndex:
    def __init__(self) -> None:
        self.paths: Dict[str, List[Tuple[int, int, int, int]]] = {}
        # header -> [(bytePos, absPos, len, step)]
        self.sort_order: List[str] = []
        self.index_byte_size = 0
        self.k = 0


def read_index(data: bytes, off: int, idx: BkwigIndex) -> int:
    """Reference: src/decompressor.cpp:78-117."""
    byte_pos = 0
    (npaths,) = struct.unpack_from("<I", data, off)
    off += 4
    idx.index_byte_size += 4
    for _ in range(npaths):
        (hsize,) = struct.unpack_from("<H", data, off)
        off += 2
        header = data[off:off + hsize].decode("latin-1")
        off += hsize
        (ncomp,) = struct.unpack_from("<I", data, off)
        off += 4
        idx.index_byte_size += 2 + hsize + 4
        comps = []
        for _c in range(ncomp):
            abs_pos, ln = struct.unpack_from("<QQ", data, off)
            off += 16
            (step,) = struct.unpack_from("<B", data, off)
            off += 1
            idx.index_byte_size += 17
            comps.append((byte_pos, abs_pos, ln, step))
            byte_pos += 12 * ln
        idx.paths[header] = comps
        idx.sort_order.append(header)
    return off


def _print_triples(values, out) -> None:
    from ..io.writers import write_csv_rows3

    write_csv_rows3(values, out)


def _expand_rows(header: str, abs_pos: int, vals, k: int, out,
                 init=None) -> None:
    """Sliding-window expansion (reference:
    src/decompressor.cpp:532-580).  `init` optionally seeds the three
    k-1-deep windows (lookup's span-context priming); strings are
    converted once per value instead of once per covering window."""
    arr = np.asarray(vals, np.uint32).reshape(-1, 3)
    tracks = []
    for c in range(3):
        ini = (np.zeros(k - 1, np.uint32) if init is None
               else np.asarray(init[c], np.uint32))
        tracks.append([str(v) for v in
                       np.concatenate([ini, arr[:, c]]).tolist()])
    covs, efws, ebws = tracks
    for i in range(arr.shape[0]):
        out.write(f"{header},{abs_pos + i},"
                  + ",".join(covs[i:i + k]) + ","
                  + ",".join(efws[i:i + k]) + ","
                  + ",".join(ebws[i:i + k]) + "\n")


def inflate(data: bytes, idx: BkwigIndex, expand: bool, out) -> None:
    """Reference: src/decompressor.cpp:493-584."""
    off = 1 + idx.index_byte_size
    for header in idx.sort_order:
        if off >= len(data):
            out.write("Error: file truncated\n")
            sys.exit(1)
        for _bp, abs_pos, ln, step in idx.paths[header]:
            vals = np.frombuffer(data, "<u4", ln * 3, off)
            off += 12 * ln
            if not expand:
                out.write(f"fixedStep chrom={header} start={abs_pos} "
                          f"step={step}\n")
                _print_triples(vals, out)
            else:
                _expand_rows(header, abs_pos, vals, idx.k, out)


def lookup(data: bytes, idx: BkwigIndex, header: str,
           coords: List[Tuple[int, int]], span: int, expand: bool,
           out) -> None:
    """Reference: src/decompressor.cpp:119-249."""
    if header not in idx.paths:
        sys.stderr.write(f"Could not find header ({header}) Exiting.\n")
        sys.exit(1)
    index = idx.paths[header]
    init_offset = 1 + idx.index_byte_size

    for begin, endc in coords:
        start = begin - span - 1
        end = endc + span - 1
        offset = init_offset
        for byte_pos, abs_pos, ln, _step in index:
            if not (abs_pos <= start < abs_pos + ln):
                continue
            if end > abs_pos + ln:
                end = abs_pos + ln  # shrink span to fit; offset NOT set
            elif abs_pos + ln > end:
                offset += byte_pos + (start - abs_pos) * 12
                break
        ln = end - start
        if not expand:
            vals = struct.unpack_from(f"<{ln * 3}I", data, offset)
            out.write(f"{header}:{start + 1}-{end + 1}\n")
            _print_triples(vals, out)
        else:
            k = idx.k
            p = k
            offset -= k * 12
            if offset < init_offset:
                offset = init_offset
                p = k - start  # reference keeps this ("this is wrong")
            if p < 0:  # np.frombuffer(-n) would silently read-all
                raise ValueError(
                    f"lookup span context underflows the data area "
                    f"(p={p}); corrupt index or coordinates")
            pre = np.frombuffer(data, "<u4", p * 3, offset).reshape(-1, 3)
            offset += p * 12
            # prime the k-1-deep windows with the span context
            init = []
            for c in range(3):
                stream = np.concatenate(
                    [np.zeros(k - 1, np.uint32), pre[:, c]])
                init.append(stream[len(stream) - (k - 1):])
            vals = np.frombuffer(data, "<u4", ln * 3, offset)
            _expand_rows(header, start, vals, k, out, init=init)
        out.write("\n")


def parse_coordinate(arg: str) -> Tuple[str, int, int]:
    """'header[:start-end]' (reference: gfalibs parseCoordinate)."""
    if ":" in arg:
        header, rng = arg.split(":", 1)
        a, b = rng.split("-", 1)
        return header, int(a), int(b)
    return arg, 0, 0


def print_help() -> None:
    print("decompressor [mode]\n-h for additional help.\n")
    print("Modes:")
    print("inflate")
    print("lookup")
    sys.exit(0)


def run(argv: List[str]) -> int:
    if len(argv) < 2:
        print_help()
    mode = argv[1]
    if mode not in ("inflate", "lookup"):
        sys.stderr.write(f"Unrecognized mode: {mode}\n")
        print_help()

    input_file = ""
    coord_file = ""
    span = 0
    expand = False
    bed: List[Tuple[str, int, int]] = []
    i = 2
    while i < len(argv):
        a = argv[i]
        if a in ("-i", "--input-file"):
            input_file = argv[i + 1]
            i += 2
        elif a in ("-c", "--coordinate-file"):
            coord_file = argv[i + 1]
            i += 2
        elif a in ("-s", "--span"):
            span = int(argv[i + 1])
            i += 2
        elif a == "--expand":
            expand = True
            i += 1
        elif a in ("-o", "-m", "-j"):
            i += 2
        elif a in ("--cmd", "--verbose"):
            i += 1
        elif not a.startswith("-"):
            bed.append(parse_coordinate(a))
            i += 1
        else:
            i += 2

    with open(input_file, "rb") as fh:
        data = fh.read()
    idx = BkwigIndex()
    idx.k = data[0]
    out = sys.stdout
    if not expand:
        out.write(f"{idx.k}\n")
    read_index(data, 1, idx)

    if mode == "inflate":
        inflate(data, idx, expand, out)
    else:
        if coord_file:
            with open(coord_file) as fh:
                for line in fh:
                    parts = line.split()
                    if len(parts) >= 3:
                        bed.append((parts[0], int(parts[1]), int(parts[2])))
        headers: List[str] = []
        coords: Dict[str, List[Tuple[int, int]]] = {}
        for h, b, e in bed:
            if h not in coords:
                coords[h] = []
                headers.append(h)
            coords[h].append((b, e))
        for h in headers:
            lookup(data, idx, h, coords[h], span, expand, out)
    return 0


def main() -> None:
    sys.exit(run(sys.argv))


if __name__ == "__main__":
    main()
