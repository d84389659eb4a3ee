"""med_tpu_torch — the PyTorch and CUDA port of med_tpu for NVIDIA Hopper.

It mirrors ``med_tpu``'s module names. It imports neither JAX nor any module
of ``med_tpu``: it keeps its own copies of what it needs. Entry points run on
CUDA unless the caller passes ``device="cpu"``, and raise when there is no
CUDA device.
"""

from . import config  # noqa: F401
