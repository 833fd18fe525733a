"""ragfin_tpu_torch: the PyTorch/CUDA port of ragfin_tpu.

The JAX package ``ragfin_tpu`` stays the reference; this package mirrors its
layout (config, data, eval, models, ops, index, retrieval, serving, utils)
and never imports JAX or anything of ``ragfin_tpu``. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``; the hand-written
Hopper kernels live in ``csrc/`` and are built on first use.
"""
