"""Operators of the port. Each hand-written CUDA kernel sits beside its plain
PyTorch version; a wrapper launches the kernel for a CUDA tensor, runs the
plain version for a CPU tensor, and counts its launches in ``.launches``."""

from .attention import (
    sliding_window_attention,
    sliding_window_attention_bwd_pallas,
    sliding_window_attention_packed,
    sliding_window_attention_packed_bwd,
    sliding_window_attention_pallas,
)
from .resnet_fused import fused_bottleneck_stage
from .tcn_fused import (
    dilated_residual_multistack,
    dilated_residual_multistack_bwd,
    dilated_residual_multistack_stages,
    dilated_residual_multistack_stages_bwd,
    dilated_residual_stack,
    dilated_residual_stack_bwd,
)

KERNEL_WRAPPERS = (
    sliding_window_attention_packed,
    dilated_residual_multistack_stages,
    dilated_residual_stack,
    sliding_window_attention_packed_bwd,
    dilated_residual_multistack_stages_bwd,
    dilated_residual_stack_bwd,
    fused_bottleneck_stage,
    dilated_residual_multistack,
    dilated_residual_multistack_bwd,
    sliding_window_attention_pallas,
    sliding_window_attention_bwd_pallas,
)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
