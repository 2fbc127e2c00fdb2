"""AFrame on PyTorch: the DataFrame engine of ``repro`` over torch tensors,
with its relational kernels written by hand in CUDA C++ for Hopper.

Module paths mirror ``repro`` (``repro_torch.core.frame`` is the port of
``repro.core.frame``, and so on). The package imports torch and never jax.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper takes its plain
PyTorch version instead.
"""
