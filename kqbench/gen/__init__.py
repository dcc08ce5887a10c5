"""Input generators, found by the `generator` key of a configuration
file: kqbench/gen/<generator>.py with a `make(config, seed, workdir)`
that writes the inputs and returns an `Inputs`."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Inputs:
    """What a generator wrote, and the sequences the reference reads."""

    files: dict  # role ("reads", "asm") -> path
    reads: np.ndarray  # uint8 base codes of every read, concatenated
    offsets: np.ndarray  # int64 [n + 1]: read i is reads[o[i]:o[i + 1]]
    records: list  # the assembly: (name, sequence bytes) per record
    sizes: dict = field(default_factory=dict)  # read_bases, asm_bases, ...


def make(config: dict, seed: int, workdir: str) -> Inputs:
    mod = importlib.import_module(f"kqbench.gen.{config['generator']}")
    return mod.make(config, seed, workdir)
