"""mdi_llm_tpu_torch: the PyTorch/CUDA port of mdi_llm_tpu for NVIDIA Hopper.

A second package beside the JAX one, module for module (`config`,
`ops/...`, `models/transformer`, `serving/...`, `cli/serve`).  It imports
torch and numpy, never jax or the JAX package.  Kernels are hand-written
CUDA (`csrc/`), built at first use (`kernels.py`).  Entry points run on
the GPU unless the caller asks for the CPU.
"""
