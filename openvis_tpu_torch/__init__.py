"""openvis-tpu on PyTorch and CUDA: the port of the JAX package ``openvis_tpu``.

Mirrors the JAX package's module paths.  Plain tensor code is PyTorch; the
Pallas TPU kernels on the ported path are CUDA C++ kernels written for Hopper
(``csrc/``), built at first use.  The configuration is the JAX package's own
dataclasses (``openvis_tpu/config.py`` imports no JAX).
"""

from openvis_tpu.config import Config, load_config  # noqa: F401
