"""Regenerate golden `.tst` files with the PyTorch port (reference:
src/generate-tests.cpp; counterpart of kreeq_tpu/cli/generate_tests.py,
whose matrix, messages and file bytes it keeps).

Wipes `validateFiles/*.tst` and regenerates each from the declarative
matrix by running the port's CLI, embedding its stdout as the golden.
Run from a directory containing `testFiles/` and `validateFiles/`:

    python -m kreeq_tpu_torch.cli.generate_tests

The device is KREEQ_TPU_PLATFORM's, as in validate_runner.
"""

from __future__ import annotations

import glob
import os
import sys

from .validate_runner import run_command

VALIDATE_MATRIX = [
    "-r testFiles/random1.fastq",
    "-r testFiles/random2.fastq",
    "-r testFiles/random1.fastq.gz",
    "-r testFiles/random1.fastq testFiles/random2.fastq",
    "-r testFiles/random1.fastq.gz testFiles/random2.fastq.gz",
]
VALIDATE_EXTS = {"fasta", "fasta.gz", "fastq", "fastq.gz", "gfa"}
EXCLUDE = {
    "random4.fasta", "random4.fastq", "random5.fasta", "random5.fastq",
    "random6.fastq", "random7.fastq", "random8.fastq", "random9.fastq",
    "random10.fastq", "random11.fasta", "random11.fastq",
    "random12.fasta", "random12.fastq", "to_correct.fasta",
    "to_correct.fastq", "decompressor1.fasta", "repeat1.fasta",
    "repeat1.fastq",
}
SUBGRAPH_MATRIX = [
    "-d testFiles/test1.kreeq -f testFiles/random1.fasta "
    "--search-depth 0 --no-collapse",
    "-d testFiles/random5.kreeq -f testFiles/random5.fasta --no-collapse",
    "-d testFiles/random5.kreeq -f testFiles/random5.fasta",
    "-d testFiles/random6.kreeq -f testFiles/random5.fasta",
    "-d testFiles/random7.kreeq -f testFiles/random5.fasta",
    "-d testFiles/random8.kreeq -f testFiles/random5.fasta",
    "-d testFiles/random9.kreeq -f testFiles/random5.fasta",
    "-d testFiles/random10.kreeq -f testFiles/random5.fasta "
    "--search-depth 15 --traversal-algorithm traversal",
    "-d testFiles/random10.kreeq -f testFiles/random5.fasta "
    "--search-depth 16 --traversal-algorithm traversal",
    "-d testFiles/random10.kreeq -f testFiles/random5.fasta "
    "--search-depth 32 --traversal-algorithm best-first",
    "-d testFiles/random11.kreeq -f testFiles/random11.fasta "
    "--search-depth 32 --traversal-algorithm best-first --no-collapse",
    "-d testFiles/random12.kreeq -f testFiles/random12.fasta "
    "--search-depth 21 --traversal-algorithm best-first --no-collapse",
]


def _ext(name: str) -> str:
    if name.endswith(".gz"):
        return _ext(name[:-3]) + ".gz"
    return name.rsplit(".", 1)[1] if "." in name else ""


def main() -> None:
    print("WARNING: only run this program if the program is in a working "
          "state")
    print("WARNING: previous validate files will be deleted")
    answer = input("continue? (Y/N) ")
    if answer not in ("Y", "y"):
        print("validate generation cancelled")
        sys.exit(0)
    print("deleting old validate files...")
    for f in glob.glob("validateFiles/*.tst"):
        os.remove(f)
    print("generating new validate files...")

    counter = 0

    def gen(executable: str, mode: str, inp: str, args: str) -> None:
        nonlocal counter
        tst = f"validateFiles/test.{counter}.tst"
        print(f"generating: {tst}")
        cmd = f"{executable} {mode} {inp} {args}".rstrip() + " "
        output = run_command(cmd)
        with open(tst, "w") as fh:
            fh.write(f"{cmd}\nembedded\n{output}")
        counter += 1

    for fname in sorted(os.listdir("testFiles")):
        if fname in EXCLUDE or _ext(fname) not in VALIDATE_EXTS:
            continue
        for args in VALIDATE_MATRIX:
            gen("kreeq", "validate", f"-f testFiles/{fname}", args)

    gen("kreeq", "union", "-d testFiles/test1.kreeq testFiles/test2.kreeq",
        "")
    for inp in SUBGRAPH_MATRIX:
        gen("kreeq", "subgraph", inp, "")
    gen("kreeq-decompressor", "lookup",
        "-i testFiles/decompressor1.bkwig -c testFiles/decompressor1.bed",
        "")
    gen("kreeq-decompressor", "inflate", "-i testFiles/decompressor2.bkwig",
        "")
    if os.path.exists("testFiles/to_correct.fasta"):
        gen("kreeq", "validate", "-f testFiles/to_correct.fasta",
            "-r testFiles/to_correct.fastq -o vcf --search-depth 50 "
            "--max-span 32")


if __name__ == "__main__":
    main()
