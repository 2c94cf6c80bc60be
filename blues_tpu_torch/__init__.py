"""PyTorch port of blues_tpu: the frozen and unfrozen NCMC paths on one
CUDA GPU.

Imports ``torch`` and never ``jax``. Module names follow ``blues_tpu`` so
each counterpart is easy to find; the pair kernels are hand-written CUDA
kernels (``csrc/sweep_kernel.cu`` for the frozen sweep,
``csrc/pair_kernel.cu`` for the all-pairs sum, ``csrc/cells_kernel.cu`` for
the cell list) built at first use. Every builder stages its tensors on the
card unless it is given ``device="cpu"``.
"""
