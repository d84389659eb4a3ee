"""Operators of the port. Each hand-written CUDA kernel sits beside its plain
PyTorch version; a wrapper launches the kernel for a CUDA tensor, runs the
plain version for a CPU tensor, and counts its launches in ``.launches``."""

from .attention import sliding_window_attention_packed
from .tcn_fused import dilated_residual_multistack_stages, dilated_residual_stack

KERNEL_WRAPPERS = (
    sliding_window_attention_packed,
    dilated_residual_multistack_stages,
    dilated_residual_stack,
)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
