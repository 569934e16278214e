"""lmrl_gym_torch — the PyTorch/CUDA port of lmrl_gym_tpu for NVIDIA Hopper.

Module paths and public names mirror `lmrl_gym_tpu` so each counterpart is
easy to find. The package imports `torch` and never `jax`, `flax` or
`lmrl_gym_tpu`. Entry points run on `cuda` unless the caller passes
`device="cpu"`; without a CUDA device they raise instead of falling back.

The attention kernels that the JAX package wrote in Pallas are hand-written
CUDA C++ here (`csrc/`, bound in `ops/`), built with `nvcc` at first use.
"""
