"""Hand-written CUDA kernels (sources in ``mlcomp_tpu_torch/csrc``), each
with its plain PyTorch version and a launch counter; the counterpart of
``mlcomp_tpu/ops/pallas``."""
