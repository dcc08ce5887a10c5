"""One rank of the port's sharded tests (not collected: no test_ prefix).

Usage: python torch_sharded_worker.py <rank> <ranks> <port> <dir>

Joins a gloo group of <ranks> processes on the CPU, runs every job of
<dir>/jobs.json with the inputs of <dir>/inputs.npz, and writes this
rank's results to <dir>/out_<rank>.npz.  Imports no jax.
"""

import json
import os
import sys

os.environ["KREEQ_TPU_PLATFORM"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kreeq_tpu_torch.constants import keys_to_u64  # noqa: E402
from kreeq_tpu_torch.core.table import KmerTable  # noqa: E402
from kreeq_tpu_torch.parallel import sharded  # noqa: E402
from kreeq_tpu_torch.utils import log  # noqa: E402

rank, ranks, port, work = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=ranks, rank=rank)
group = dist.group.WORLD
cpu = torch.device("cpu")
with open(os.path.join(work, "jobs.json")) as fh:
    jobs = json.load(fh)
inputs = np.load(os.path.join(work, "inputs.npz"))
out = {}


def save(name, keys, cov, fw, bw):
    """A table's rows (tensors, or host arrays) in the JAX package's
    dtypes."""
    out[f"{name}.keys"] = keys_to_u64(np.asarray(keys))
    for field, a in zip(("cov", "fw", "bw"), (cov, fw, bw)):
        out[f"{name}.{field}"] = np.asarray(a).astype(np.uint32)


for job in jobs:
    name, kind = job["name"], job["kind"]
    os.environ.update(job.get("env", {}))
    with log.job() as rec:
        if kind == "count":
            codes = torch.from_numpy(inputs[job["codes"]][rank])
            keys, cov, fw, bw, n = sharded.sharded_count(codes, job["k"],
                                                         group)
            m = int(n)
            save(name, keys[:m], cov[:m], fw[:m], bw[:m])
        elif kind == "pipeline":
            qfound, qcov, tot, miss, emiss = sharded.full_pipeline(
                torch.from_numpy(inputs[job["reads"]][rank]),
                torch.from_numpy(inputs[job["asm"]][rank]), job["k"],
                group, job.get("cutoff", 0))
            out[f"{name}.qfound"] = qfound.numpy()
            out[f"{name}.qcov"] = qcov.numpy()
            out[f"{name}.sums"] = np.array([tot, miss, emiss])
        elif kind == "merge":
            a, b = (KmerTable.from_numpy(
                job["k"], *(inputs[f"{t}.{f}"]
                            for f in ("keys", "cov", "fw", "bw")), cpu)
                    for t in ("a", "b"))
            got = a.merge_sharded(b, group)
            save(name, *got.host_arrays())
        elif kind == "from_reads":
            got = KmerTable.from_reads(job["files"], job["k"], cpu,
                                       chunk=job["chunk"], group=group)
            save(name, *got.host_arrays())
        else:
            raise ValueError(kind)
    # (gathers, of them into host memory) of the job
    out[f"{name}.gathers"] = np.array([
        rec["spans"].get("kq.shard.gather", {"calls": 0})["calls"],
        rec["counters"].get("shard.host_gathers", 0)])
    for var in job.get("env", {}):
        os.environ.pop(var)
np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
dist.destroy_process_group()
