"""PyTorch port of blues_tpu: the frozen NCMC main path on one CUDA GPU.

Imports ``torch`` and never ``jax``. Module names follow ``blues_tpu`` so
each counterpart is easy to find; the sweep pair kernel is a hand-written
CUDA kernel (``csrc/sweep_kernel.cu``) built at first use.
"""
