"""Several ranks, one table: the sharded build, probe and union
(sharded.py) and the multi-process launch (multihost.py) over
torch.distributed; counterpart of kreeq_tpu/parallel/."""
