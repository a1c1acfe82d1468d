from .fused_forward import HeadWeights, fused_forward, head_weights, supports_fused
from .gated_stack import (
    GatedStackWeights,
    KernelWeights,
    gated_stack,
    gated_stack_ref,
    kernel_weights,
    stack_weights,
)
from .sampler_kernel import fused_sample, fused_sample_ref, sampler_tables

__all__ = [
    "GatedStackWeights",
    "HeadWeights",
    "KernelWeights",
    "fused_forward",
    "fused_sample",
    "fused_sample_ref",
    "gated_stack",
    "gated_stack_ref",
    "head_weights",
    "kernel_weights",
    "sampler_tables",
    "stack_weights",
    "supports_fused",
]
