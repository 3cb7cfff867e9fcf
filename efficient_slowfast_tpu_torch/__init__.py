"""PyTorch/CUDA port of efficient_slowfast_tpu (Efficient-SlowFast).

A package of its own beside the JAX package, with the same subpackages
(config, data, models, ops, engine, utils). It imports torch and never JAX or
anything of efficient_slowfast_tpu. Its hand-written Hopper kernels live in
csrc/ and are built at first use (ops/kernels/_build.py).
"""

__version__ = "0.1.0"
