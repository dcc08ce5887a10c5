"""Output file kinds, found by name: a traffic's `files` maps each file
a job writes to its kind, and kqbench/kinds/<kind>.py judges it.

A kind module holds
  CHECK: the name of its check in a result's `checks`;
  LIMIT: the most values a sound job's file may have off;
  TRACKS: whether its reference needs the per-base tracks scored
    (reference/validate.score(..., tracks=True)); optional, False;
  expected(table, records, score) -> bytes: the reference's file for
    a job over the reference table, the assembly records and their
    score, which the reference computes once a job;
  values_off(got, want) -> int: the values of a job's file that
    differ from the reference's.
A new kind is a new file here; nothing else changes.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import re

DIRS = (os.path.dirname(os.path.abspath(__file__)),)
_NAME = re.compile(r"[A-Za-z0-9_]+")


@functools.lru_cache(maxsize=None)
def _load(path: str):
    s = importlib.util.spec_from_file_location(
        "kqbench.kinds." + os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def find(kind: str):
    """The module of a file kind: the first <kind>.py in DIRS."""
    if _NAME.fullmatch(kind):
        for d in DIRS:
            path = os.path.join(d, kind + ".py")
            if os.path.isfile(path):
                return _load(path)
    raise ValueError(f"no file kind {kind!r}: no {kind}.py in "
                     f"{', '.join(DIRS)}")

