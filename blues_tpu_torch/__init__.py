"""PyTorch port of blues_tpu: the frozen and unfrozen NCMC paths on one
CUDA GPU.

Imports ``torch`` and never ``jax``. Module names follow ``blues_tpu`` so
each counterpart is easy to find; the pair kernels are hand-written CUDA
kernels (``csrc/sweep_kernel.cu`` for the sweep and all-pairs sums,
``csrc/cells_kernel.cu`` for the cell list) built at first use.
"""
