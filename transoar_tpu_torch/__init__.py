"""transoar_tpu_torch — the PyTorch/CUDA port of transoar_tpu for NVIDIA
Hopper GPUs.

Same layout as ``transoar_tpu`` (models/, ops/, training/, data/, utils/)
and the same numbers: every module is held against its JAX counterpart by
the ``tests/test_torch_*.py`` parity tests. The JAX package's TPU kernels
become hand-written CUDA kernels under ``csrc/``, built at first use. The
package imports torch, numpy, scipy and pyyaml, and never jax, flax or
``transoar_tpu``: it keeps its own copies of the host-side helpers.
"""

__version__ = "0.1.0"
