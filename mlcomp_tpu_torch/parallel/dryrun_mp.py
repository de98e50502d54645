"""Multi-process dry run: one gloo process of N, on the CPU.

The counterpart of mlcomp_tpu/parallel/dryrun_mp.py.  Run as ``python -m
mlcomp_tpu_torch.parallel.dryrun_mp`` with the gang environment
(``MLCOMP_TPU_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID``) in each of N
processes.  Each process is one rank of a ``dp = N`` mesh (where the JAX
dry run contributes virtual devices) and runs ONE real data-parallel
train step of a small MLP: the sharded state, each rank's rows of the
global batch and the gradient average the Trainer uses under a gang
(scheduler/child.py).

Exit 0 only if the process group, the sharded step, and the cross-process
loss agreement all check out.
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from mlcomp_tpu_torch.parallel.distributed import (
        global_batch_from_host, init_distributed, process_count, process_index)

    assert init_distributed(device="cpu"), "gang env missing"
    n_proc = int(os.environ["MLCOMP_TPU_NUM_PROCESSES"])
    assert process_count() == n_proc, (process_count(), n_proc)

    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.parallel import collectives as col
    from mlcomp_tpu_torch.parallel.mesh import MeshSpec, make_mesh, set_current_mesh
    from mlcomp_tpu_torch.parallel.sharding import make_sharded_state
    from mlcomp_tpu_torch.train.loop import make_train_step
    from mlcomp_tpu_torch.train.losses import create_loss
    from mlcomp_tpu_torch.train.optim import create_optimizer

    mesh = make_mesh(MeshSpec(dp=n_proc), device_type="cpu")
    set_current_mesh(mesh)
    model = create_model({"name": "mlp", "num_classes": 4, "hidden": [16]}, device="cpu")
    params, model_state = model.init_variables(0, "cpu", (1, 8))
    model.load_variables(params, model_state, train=True)
    state, _ = make_sharded_state(model, create_optimizer({"name": "sgd", "lr": 0.1}), mesh)

    # every process assembles the same global batch and keeps its rows
    rs = np.random.RandomState(0)
    x = rs.rand(2 * n_proc, 8).astype(np.float32)
    y = rs.randint(0, 4, size=(2 * n_proc,))
    batch = global_batch_from_host({"x": x, "y": y}, mesh)
    step = make_train_step(create_loss("cross_entropy"), {})
    stats = step(state, batch)
    loss = float(stats["loss"])
    assert np.isfinite(loss), loss
    assert int(state.step) == 1
    # the reported loss is the global mean: every process holds the same
    seen = torch.tensor([loss], dtype=torch.float64)
    lo, hi = seen.clone(), seen.clone()
    col.all_reduce_(lo, torch.distributed.group.WORLD, torch.distributed.ReduceOp.MIN)
    col.all_reduce_(hi, torch.distributed.group.WORLD, torch.distributed.ReduceOp.MAX)
    assert float(lo) == float(hi) == loss, (float(lo), float(hi), loss)
    print(f"dryrun_mp process {process_index()}/{n_proc}: {n_proc} ranks, loss {loss:.4f}")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
