"""ctypes bindings for the native host helpers (builds on first use).

Host code only: the FASTX parser turns a FASTA/FASTQ file (plain or
gzip) into one ReadBatch of uint8 codes; the phmap helpers parse and
place the records of `.kreeq` archives.  The shared library is built
with g++ into the package's gitignored `_build/` directory, keyed on a
hash of the source.  Without a compiler (or zlib) the callers fall back to the
pure-Python code in io/fastx.py and io/kreeqdb.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "kreeq_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(BUILD_DIR, "libkreeq_native.so")

_lib = None
_tried = False


def build(src: str, lib: str, cmd: List[str], key: str = "") -> bool:
    """Compile `src` into `lib` with `cmd` (the compiler command without
    its output path) unless `lib` was built from the same source and
    `key`: a content hash decides, since mtimes don't survive git.
    Returns False when the compiler is missing or fails."""
    with open(src, "rb") as fh:
        want = hashlib.sha256(fh.read()).hexdigest() + key
    stamp = lib + ".srchash"
    try:
        with open(stamp) as fh:
            if fh.read().strip() == want and os.path.exists(lib):
                return True
    except OSError:
        pass
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        res = subprocess.run(cmd + ["-o", tmp], capture_output=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0:
        return False
    os.replace(tmp, lib)
    with open(stamp, "w") as fh:
        fh.write(want)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not build(_SRC, _LIB, ["g++", "-O3", "-std=gnu++17", "-shared",
                              "-fPIC", _SRC, "-lz"]):
        return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    lib.kn_parse_fastx.restype = ctypes.c_void_p
    lib.kn_parse_fastx.argtypes = [ctypes.c_char_p]
    lib.kn_num_seqs.restype = ctypes.c_uint64
    lib.kn_num_seqs.argtypes = [ctypes.c_void_p]
    lib.kn_num_codes.restype = ctypes.c_uint64
    lib.kn_num_codes.argtypes = [ctypes.c_void_p]
    lib.kn_codes.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.kn_codes.argtypes = [ctypes.c_void_p]
    lib.kn_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.kn_offsets.argtypes = [ctypes.c_void_p]
    lib.kn_free.argtypes = [ctypes.c_void_p]

    lib.kn_parse_phmap.restype = ctypes.c_void_p
    lib.kn_parse_phmap.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_uint64, ctypes.c_int]
    lib.kn_phmap_count.restype = ctypes.c_uint64
    lib.kn_phmap_count.argtypes = [ctypes.c_void_p]
    lib.kn_phmap_keys.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.kn_phmap_keys.argtypes = [ctypes.c_void_p]
    lib.kn_phmap_vals.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.kn_phmap_vals.argtypes = [ctypes.c_void_p]
    lib.kn_phmap_free.argtypes = [ctypes.c_void_p]
    lib.kn_phmap_place.restype = ctypes.c_int
    lib.kn_phmap_place.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_uint32)]
    _lib = lib
    return _lib


class ReadBatch:
    """The reads of one file in the layout of the device chunks: `sep`
    holds every read's codes followed by one BAD, and `ends[i]` (int64)
    is the end of read i in `sep`, its separator included.
    ops/kmers.pack_reads cuts chunks from it by read boundaries;
    iterating it gives per-read views without the separators."""

    __slots__ = ("sep", "ends")

    def __init__(self, sep: np.ndarray, ends: np.ndarray):
        self.sep = sep
        self.ends = ends

    def __iter__(self) -> Iterator[np.ndarray]:
        start = 0
        for end in self.ends.tolist():
            yield self.sep[start:end - 1]
            start = end


def parse_fastx(path: str) -> Optional[ReadBatch]:
    """Parse FASTA/FASTQ(.gz) into a ReadBatch: the parse and the copies
    out of the library are the span `kq.ingest.parse` (counters
    `ingest.files`, `ingest.reads`, `ingest.bases`: bases only, not the
    separators), the batch's read index (`ends`) `kq.ingest.views`."""
    from ..utils import log

    lib = get_lib()
    if lib is None:
        return None
    with log.span("kq.ingest.parse"):
        h = lib.kn_parse_fastx(path.encode())
        if not h:
            return None
        try:
            n_seqs = lib.kn_num_seqs(h)
            n_codes = lib.kn_num_codes(h)
            log.count("ingest.files")
            log.count("ingest.reads", n_seqs)
            log.count("ingest.bases", n_codes - n_seqs)
            if n_seqs == 0:
                return ReadBatch(np.zeros(0, np.uint8), np.zeros(0, np.int64))
            sep = np.ctypeslib.as_array(lib.kn_codes(h),
                                        shape=(n_codes,)).copy()
            starts = np.ctypeslib.as_array(lib.kn_offsets(h),
                                           shape=(n_seqs,)).copy()
        finally:
            lib.kn_free(h)
    with log.span("kq.ingest.views"):
        ends = np.empty(n_seqs, np.int64)
        ends[:-1] = starts[1:]
        ends[-1] = n_codes
        return ReadBatch(sep, ends)


def phmap_place(hashes: np.ndarray, cap: int) -> Optional[np.ndarray]:
    """SwissTable slot positions for one submap (mixed hashes, cap=2^n-1)."""
    lib = get_lib()
    if lib is None:
        return None
    hs = np.ascontiguousarray(hashes, np.uint64)
    pos = np.empty(len(hs), np.uint32)
    rc = lib.kn_phmap_place(
        hs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(hs), cap,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        raise ValueError("phmap placement over-filled a submap")
    return pos


def parse_phmap(data: bytes, wide: bool) -> Optional[Tuple[np.ndarray,
                                                           np.ndarray]]:
    """Parse a phmap dump into (keys u64[n], vals u32[n,9])."""
    lib = get_lib()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    h = lib.kn_parse_phmap(buf, len(data), 1 if wide else 0)
    if not h:
        raise ValueError("corrupt phmap archive")
    try:
        n = lib.kn_phmap_count(h)
        if n == 0:
            return (np.zeros(0, np.uint64), np.zeros((0, 9), np.uint32))
        keys = np.ctypeslib.as_array(lib.kn_phmap_keys(h),
                                     shape=(n,)).copy()
        vals = np.ctypeslib.as_array(lib.kn_phmap_vals(h),
                                     shape=(n, 9)).copy()
        return keys, vals
    finally:
        lib.kn_phmap_free(h)
