"""The benchmark of kreeq_tpu_torch: whole kreeq jobs on a CUDA card,
driven by the data files of this folder (see run.py)."""
