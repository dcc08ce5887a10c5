"""`kreeq warmup`: pay the port's cold start before the real runs
(counterpart of kreeq_tpu/cli/warmup.py, whose options, messages and
shape set it keeps).

The port compiles no program per shape, so there is no compile cache to
fill.  Its cold start is the nvcc build of ops/csrc/ into `_build/`
(ops/_build.py: once per source hash, kept across processes), then the
library load and the first launch of each kernel in a process.  On the
card, warmup builds and loads the library, then runs each program once
at the JAX set's shapes: the extraction (kmer_extract) and the count
(B1) on one read chunk, the merge (B2) on equal pow2 pairs up the
build tree, the table's bucket directory (ops/index.py) and both
validate probes (B3, B4) for each table size, and the variants scan
with the generic probe (B5) on one window for each table size; the
probes and the scan launch the extraction again, in their forms.  On
the CPU it runs the plain versions of the same set.  A build or launch
failure raises: nothing falls back.

Usage: kreeq warmup [-k <len>] [--chunk N] [--window N] [--small]
"""

from __future__ import annotations

import sys
import time
from typing import List


def _compile_set(k: int, chunk: int, window: int, small: bool) -> int:
    import numpy as np
    import torch

    from ..core.variants import (_candidate_scan, _extract_sentinel,
                                 _variants_window_cap)
    from ..device import resolve_device
    from ..ops.index import bucket_index
    from ..ops.kernels import (count_sorted_cuda, extract_cuda,
                               merge_sorted_cuda, probe_sorted_cuda)
    from ..ops.validate import validate_positions, validate_qv_sums
    from ..utils import log

    device = resolve_device()
    if device.type == "cuda":
        from ..ops import _build

        t0 = time.perf_counter()
        _build.build()
        _build.library()
        log.verbose(f"warmup: kernel library built and loaded "
                    f"({time.perf_counter() - t0:.1f}s)")

    rng = np.random.default_rng(0)
    n_compiled = 0

    def codes(n: int) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8)).to(
            device)

    def tick(name, fn):
        nonlocal n_compiled
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        n_compiled += 1
        log.verbose(f"warmup: {name} ({dt:.1f}s)")
        return out

    # 1. extraction + count at the standard chunk
    cbuf = codes(chunk)

    def count():
        keys, _isfw, edges, valid = extract_cuda(cbuf, k)
        return count_sorted_cuda(keys, edges, valid)

    tkeys, cov, fw, bw, _n = tick(f"count @{chunk}", count)
    rows = tkeys.shape[0]

    # 2. merge shapes: equal pow2 pairs up the build tree, up to the
    # table's row count
    sizes = [1 << i for i in range(20, 24)] if not small else [1 << 12]
    for s in sizes:
        if s > rows:
            break
        a = (tkeys[:s], cov[:s], fw[:s], bw[:s])
        tick(f"merge {s}+{s}", lambda a=a: merge_sorted_cuda(*a, *a))

    # 3. validate windows against each table size: the bucket directory,
    # then the track probe and the sums-only QV probe (what plain
    # `validate` runs per window)
    wbuf = codes(window + k + 1)
    buckets = ([3 << 21, 1 << 23, 3 << 22, 1 << 24] if not small
               else [1 << 12])

    def table(b: int):
        t = min(b, rows)
        return t, (tkeys[:t], cov[:t], fw[:t], bw[:t])

    indices = []
    for b in buckets:
        t, tab = table(b)
        index = tick(f"bucket-index t={t}",
                     lambda: bucket_index(tab[0], k))
        indices.append(index)
        tick(f"probe-select t={t}",
             lambda: validate_positions(*tab, wbuf, k, 0, index))
        tick(f"probe-qv t={t}",
             lambda: validate_qv_sums(*tab, wbuf, k, 0, 0,
                                      wbuf.shape[0] - k + 1, index))

    # 4. the variants scan (`-o vcf` / `-o gfa` paths) at the production
    # window, core plus halos: extraction + sentinels, the generic probe
    # through the table size's directory, and the depth-0 candidate scan
    vwin = _variants_window_cap() if not small else (1 << 10)
    vbuf = codes(vwin + 2 * k + 12)
    for b, index in zip(buckets, indices):
        t, tab = table(b)

        def scan():
            keys, isfw, valid = _extract_sentinel(vbuf, k)
            found, covs, fws, bws = probe_sorted_cuda(*tab, keys, index)
            return _candidate_scan(keys, isfw, found & valid, covs, fws,
                                   bws, 0, k)

        tick(f"variants-scan t={t}", scan)
    return n_compiled


def run(argv: List[str]) -> int:
    from ..utils import log

    k = 21
    chunk = 1 << 23
    window = 1 << 22
    small = False
    i = 2
    while i < len(argv):
        a = argv[i]
        if a == "-k":
            i += 1
            k = int(argv[i])
        elif a == "--chunk":
            i += 1
            chunk = int(argv[i])
        elif a == "--window":
            i += 1
            window = int(argv[i])
        elif a == "--small":
            small = True  # tiny shapes: CI smoke of the warmup path
        elif a in ("-v", "--verbose"):
            log.set_flags(True, False)
        else:
            sys.stderr.write(f"warmup: unknown option {a}\n")
            return 1
        i += 1
    if small:
        chunk, window = 1 << 14, 1 << 12
    log.set_flags(True, False)
    t0 = time.perf_counter()
    n = _compile_set(k, chunk, window, small)
    print(f"warmup: {n} programs compiled/cached in "
          f"{time.perf_counter() - t0:.1f}s (k={k}, chunk={chunk}, "
          f"window={window})")
    return 0
