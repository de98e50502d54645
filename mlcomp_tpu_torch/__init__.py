"""mlcomp_tpu_torch: the PyTorch + CUDA port of mlcomp_tpu for NVIDIA Hopper.

This slice serves ``transformer_lm`` (all-int8 weights and KV cache)
through the window batcher: ``serve.load_service`` / ``cli serve``.  The
hand-written kernels live in ``csrc/`` and are bound in ``ops/cuda/``.
The package imports ``torch`` and never JAX or ``mlcomp_tpu``.
"""
