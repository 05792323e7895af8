"""PyTorch/CUDA port of the JAX package koboldcpp_tpu/ for NVIDIA H100s.

Same module layout as the JAX package, so each module has an obvious
counterpart there. The hot kernels are hand-written CUDA C++ for sm_90a
(`csrc/`), compiled on first use by `ops/_build.py`; each sits beside a plain
PyTorch version that runs for CPU tensors. Entry points run on the GPU unless
the caller passes device="cpu".
"""
