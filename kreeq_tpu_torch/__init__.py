"""kreeq_tpu_torch: the PyTorch + CUDA port of kreeq-tpu.

The JAX package `kreeq_tpu` beside this one is the reference.  This
package imports `torch` and never `jax` or `kreeq_tpu`.  Plain tensor
code is PyTorch; the hot kernels of the main path (count
run-aggregation, sorted merge, QV probe) are hand-written CUDA C++ for
Hopper (ops/csrc/), each with a plain PyTorch version beside it.

Keys are the same 2-bit packings of canonical k-mers as in the JAX
package, stored order-preservingly as int64 (see constants.py for the
dtype rule).
"""

__version__ = "0.1.0"
