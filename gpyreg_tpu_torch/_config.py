"""Global constants of the PyTorch port.

Carries the numerical constants of ``gpyreg_tpu/_config.py:40-46``.

Left out:

- the float64 switch (``gpyreg_tpu/_config.py:13-14``): PyTorch keeps
  each tensor's dtype, so the port needs no global mode;
- the persistent compile cache (``gpyreg_tpu/_config.py:16-33``): the
  port runs eagerly and compiles nothing at import; its two CUDA
  libraries (``csrc/kernel_tile.cu``, ``csrc/kernel_vjp.cu``) are built
  at first use into ``gpyreg_tpu_torch/build/`` (``ops/_build.py``).
"""

import torch

# Maximum Cholesky jitter-escalation attempts; mirrors the retry loop in
# reference gaussian_process.py:2413-2421 (10 tries, noise multiplier x10).
CHOL_MAX_TRIES = 10

# Threshold on min(sn2) choosing the "high-noise" Cholesky parametrization,
# reference gaussian_process.py:2404.
LCHOL_THRESHOLD = 1e-6


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means the card.  There is no
    fallback: without CUDA, the default raises and the caller passes
    ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gpyreg_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU."
        )
    return torch.device("cuda")
