"""Spans the traced run places around calls into the program's layers.

Each wraps a module attribute that the program looks up when it calls
it, so the program runs unchanged; the wrappers go in for the traced
run only and come out when it ends.  A span is a torch.profiler
annotation (named below) plus the host seconds it took; the count and
merge spans also keep, as 0-d device tensors read after the window,
the rows their calls read and wrote.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

PACK = "kq.pack_reads"
COUNT = "kq.count_chunk_cuda"
MERGE = "kq.merge_sorted_cuda"
TRACKS = "kq.validate_positions"
PHASE = "phase:"


class Spans:
    """Installed wrappers and what they recorded."""

    def __init__(self):
        self.host_s = defaultdict(float)
        self.calls = defaultdict(int)
        # per count call: rows out; per merge call: (rows a, b, out)
        self.count_rows = []
        self.merge_rows = []
        self._undo = []

    def _patch(self, module, name: str, wrapper) -> None:
        self._undo.append((module, name, getattr(module, name)))
        setattr(module, name, wrapper)

    def install(self) -> None:
        import torch
        from torch.profiler import record_function

        from kreeq_tpu_torch.constants import SENTINEL
        from kreeq_tpu_torch.ops import kernels, kmers, validate
        from kreeq_tpu_torch.utils import log

        def timed(span, fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                with record_function(span):
                    out = fn(*args, **kwargs)
                self.host_s[span] += time.perf_counter() - t0
                self.calls[span] += 1
                return out
            return call

        def real_rows(keys):
            # sorted keys with a SENTINEL tail: the rows before it
            sentinel = torch.full((1,), SENTINEL, dtype=keys.dtype,
                                  device=keys.device)
            return torch.searchsorted(keys, sentinel)[0]

        pack = kmers.pack_reads

        def pack_reads(*args, **kwargs):
            # the parse runs inside the generator, as it pulls reads
            gen = pack(*args, **kwargs)
            while True:
                t0 = time.perf_counter()
                with record_function(PACK):
                    buf = next(gen, None)
                self.host_s[PACK] += time.perf_counter() - t0
                if buf is None:
                    return
                self.calls[PACK] += 1
                yield buf

        count = timed(COUNT, kernels.count_chunk_cuda)

        def count_chunk_cuda(codes, k):
            out = count(codes, k)
            self.count_rows.append(out[4])
            return out

        merge = timed(MERGE, kernels.merge_sorted_cuda)

        def merge_sorted_cuda(*args):
            out = merge(*args)
            self.merge_rows.append((real_rows(args[0]), real_rows(args[4]),
                                    out[4]))
            return out

        phase = log.phase

        @contextlib.contextmanager
        def timed_phase(name):
            with record_function(PHASE + name), phase(name):
                yield

        self._patch(kmers, "pack_reads", pack_reads)
        self._patch(kernels, "count_chunk_cuda", count_chunk_cuda)
        self._patch(kernels, "merge_sorted_cuda", merge_sorted_cuda)
        self._patch(validate, "validate_positions",
                    timed(TRACKS, validate.validate_positions))
        self._patch(log, "phase", timed_phase)

    def uninstall(self) -> None:
        while self._undo:
            module, name, fn = self._undo.pop()
            setattr(module, name, fn)

    def rows(self):
        """(rows out of each count call, (a, b, out) of each merge) as
        ints; reads the device, so call it after the window."""
        return ([int(n) for n in self.count_rows],
                [tuple(int(x) for x in m) for m in self.merge_rows])
