"""openvis-tpu on PyTorch and CUDA: the port of the JAX package ``openvis_tpu``.

Mirrors the JAX package's module paths.  Plain tensor code is PyTorch; the
Pallas TPU kernels on the ported paths are CUDA C++ kernels written for Hopper
(``csrc/``), built at first use.  The configuration is the port's own copy of
the JAX package's dataclasses (``config.py``); the port imports nothing of
``openvis_tpu``.
"""

from openvis_tpu_torch.config import Config, load_config  # noqa: F401
