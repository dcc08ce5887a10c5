"""Loader for the subnode_ext CPython extension (host code).

subnode_ext.c is built with gcc on first use into the package's
gitignored `_build/` directory (native.build), keyed on a hash of the
source plus the interpreter's ABI tag (a CPython extension must be
rebuilt for another interpreter).  Returns None when no compiler or
headers are available: callers then use the pure-Python SubNode, which
gives the same dicts.
"""

from __future__ import annotations

import importlib.util
import os
import sysconfig

from . import BUILD_DIR, build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "subnode_ext.c")
_LIB = os.path.join(BUILD_DIR, "subnode_ext.so")

_mod = None
_tried = False


def get_module():
    """The compiled subnode_ext module, or None."""
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    _tried = True
    inc = sysconfig.get_paths()["include"]
    abi = sysconfig.get_config_var("SOABI") or "unknown-abi"
    if not build(_SRC, _LIB, ["gcc", "-O2", "-shared", "-fPIC", f"-I{inc}",
                              _SRC], "|" + abi):
        return None
    spec = importlib.util.spec_from_file_location("subnode_ext", _LIB)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except ImportError:
        return None
    _mod = mod
    return _mod
