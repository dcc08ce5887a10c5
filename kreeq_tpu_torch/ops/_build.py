"""Build and load the port's CUDA kernels (ops/csrc/*.cu).

nvcc compiles every .cu file of csrc/ for sm_90a, one process per file,
all started together, and links the objects into one shared library
with a plain C interface, in the package's gitignored `_build/`
directory, at first use.  A hash of the sources and flags decides
whether the library is stale.  A failed build raises: there is no
fallback.  The library is loaded with ctypes; pointers and the CUDA
stream pass as c_void_p, sizes as c_int64, and every entry returns the
cudaError_t of its launches.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(BUILD_DIR, "libkreeq_kernels.so")
_HASH = _LIB + ".srchash"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-shared"]

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "kq_count_runs": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "kq_merge_sorted": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                        _P, _P, _P, _P, _P, _P, _P],
    "kq_probe_qv": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P,
                    _P],
    "kq_probe_select": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P,
                        _P, _P, _P],
    "kq_probe_sorted": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P,
                        _P],
    "kq_extract": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    "kq_sort_records": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    "kq_variant_search": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I,
                          _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P,
                          _I, _P, _P, _I, _P],
    "kq_variant_search_bytes": [_I, _I, _P],
}

_lib = None


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _src_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def build() -> str:
    """Compile the kernels if the library is missing or stale.  Returns
    the compiler's report (ptxas register and memory use), empty when
    the library was up to date."""
    digest = _src_hash()
    try:
        with open(_HASH) as fh:
            if fh.read().strip() == digest and os.path.exists(_LIB):
                return ""
    except OSError:
        pass
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    report = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(objdir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compile before raising, so none outlives us
        results = [(cmd, obj, proc.communicate()[0], proc.returncode)
                   for cmd, obj, proc in jobs]
        for cmd, _obj, out, rc in results:
            if rc != 0:
                raise RuntimeError("nvcc failed to build the CUDA kernels:"
                                   "\n" + " ".join(cmd) + "\n" + out)
            report.append(out)
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *(obj for _c, obj, _o, _r
                                                in results)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed to link the CUDA kernels:\n"
                               + " ".join(cmd) + "\n" + res.stdout
                               + res.stderr)
    os.replace(tmp, _LIB)
    with open(_HASH, "w") as fh:
        fh.write(digest)
    return "".join(report)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(_LIB)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in ("kq_count_tile", "kq_merge_tile", "kq_extract_tile",
                     "kq_sort_tile"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.kq_error_string.argtypes = [ctypes.c_int]
        lib.kq_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
