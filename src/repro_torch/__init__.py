"""PyTorch/CUDA port of the CIM-MXU INT8 serving stack.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``configs``, ``kernels``, ``quant``, ``models``,
``serving``) and imports only ``torch`` and ``numpy``.  The TPU's Pallas
kernels on the serving path are hand-written CUDA kernels for Hopper
(``csrc/``), each with a plain PyTorch version beside it.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
