"""mlcomp_tpu_torch: the PyTorch + CUDA port of mlcomp_tpu for NVIDIA Hopper.

It serves ``transformer_lm`` (all-int8 weights and KV cache) through the
window batcher and the continuous engine, dense or paged
(``serve.load_service`` / ``cli serve``), and trains it through the DAG
runner (``cli dag`` → ``scheduler.local.run_dag_local`` → the ``train``
executor → ``train.loop.Trainer``).  The hand-written kernels live in
``csrc/`` and are bound in ``ops/cuda/``.  The package imports ``torch``
and never JAX or ``mlcomp_tpu``.
"""
