"""ctypes bindings for the native host helpers (builds on first use).

Host code only: the FASTX parser turns a FASTA/FASTQ file (plain or
gzip) into one ReadBatch of uint8 codes; the DB loader reads every map
file of a `.kreeq` DB into arrays allocated once, and the placement
helper places the records of its writes.  The shared library is built
with g++ into the package's gitignored `_build/` directory, keyed on a
hash of the source.  Without a compiler (or zlib) the callers fall back to the
pure-Python code in io/fastx.py and io/kreeqdb.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Iterator, List, Optional

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
                              "-fPIC", "-pthread", _SRC, "-lz"]):
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

    lib.kn_db_open.restype = ctypes.c_void_p
    lib.kn_db_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                               ctypes.c_uint64, ctypes.c_int]
    lib.kn_db_error.restype = ctypes.c_int
    lib.kn_db_error.argtypes = [ctypes.c_void_p]
    lib.kn_db_rows.restype = ctypes.c_uint64
    lib.kn_db_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kn_db_bytes.restype = ctypes.c_uint64
    lib.kn_db_bytes.argtypes = [ctypes.c_void_p]
    lib.kn_db_load.restype = ctypes.c_int64
    lib.kn_db_load.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.kn_db_tombstone_count.restype = ctypes.c_uint64
    lib.kn_db_tombstone_count.argtypes = [ctypes.c_void_p]
    lib.kn_db_tombstone_keys.restype = ctypes.POINTER(ctypes.c_int64)
    lib.kn_db_tombstone_keys.argtypes = [ctypes.c_void_p]
    lib.kn_db_close.argtypes = [ctypes.c_void_p]
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


def load_db(paths: List[str], hc_path: Optional[str]):
    """Load the map files of a `.kreeq` DB (the u8 maps `paths`, then
    the high-copy map `hc_path`, if any) in one native call: every file
    mapped, counted, then parsed on several threads straight into arrays
    allocated once.  Returns (keys, vals8, hc_vals, tombstones, nbytes):
    keys int64 [n] biased (the port's form), the live u8 rows first and
    the hc map's n_hc rows last; vals8 u8 [n, 9] (fw[4], bw[4], cov; an
    hc row's zero); hc_vals u32 [n_hc, 9]; the
    tombstones' keys int64, biased; the files' bytes.  None without the
    library; ValueError on a corrupt archive."""
    lib = get_lib()
    if lib is None:
        return None
    files = paths + ([hc_path] if hc_path else [])
    names = (ctypes.c_char_p * len(files))(*(f.encode() for f in files))
    h = lib.kn_db_open(names, len(files), 1 if hc_path else 0)
    try:
        err = lib.kn_db_error(h)
        if err > 0:
            raise OSError(err, os.strerror(err))
        if err < 0:
            raise ValueError("corrupt phmap archive")
        rows8, n_hc = lib.kn_db_rows(h, 0), lib.kn_db_rows(h, 1)
        keys = np.empty(rows8 + n_hc, np.int64)
        vals8 = np.empty((rows8 + n_hc, 9), np.uint8)
        hc_vals = np.empty((n_hc, 9), np.uint32)
        live = lib.kn_db_load(h, keys.ctypes.data, vals8.ctypes.data,
                              hc_vals.ctypes.data)
        if live < 0:
            raise ValueError("corrupt phmap archive")
        n_tomb = lib.kn_db_tombstone_count(h)
        tombstones = (np.ctypeslib.as_array(lib.kn_db_tombstone_keys(h),
                                            shape=(n_tomb,)).copy()
                      if n_tomb else np.zeros(0, np.int64))
        n = live + n_hc
        return keys[:n], vals8[:n], hc_vals, tombstones, lib.kn_db_bytes(h)
    finally:
        lib.kn_db_close(h)
