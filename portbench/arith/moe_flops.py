"""The held experts' products of one MoE call (``moe.experts``: the
SwiGLU of each expert over the rows routed to it), for the roofline of
``moe_experts_roofline``: three products of ``rows x d_model x d_expert``
(6 operations a row a weight), and at the least each held expert's three
matrices read once, the rows read once and their outputs written once,
in the weights' dtype."""

from __future__ import annotations

from .peaks import BF16_OPS_PER_S, HBM_BYTES_PER_S


def expert_ops(rows: int, d_model: int, d_expert: int) -> int:
    return 6 * rows * d_model * d_expert


def expert_bytes(rows: int, experts: int, d_model: int, d_expert: int, itemsize: int = 2) -> int:
    return (3 * experts * d_model * d_expert + 2 * rows * d_model) * itemsize


def expert_bound_s(rows: int, experts: int, d_model: int, d_expert: int, itemsize: int = 2) -> float:
    """Least seconds of one call: its operations at the bf16 peak or its
    bytes at the HBM rate, whichever is longer."""
    return max(
        expert_ops(rows, d_model, d_expert) / BF16_OPS_PER_S,
        expert_bytes(rows, experts, d_model, d_expert, itemsize) / HBM_BYTES_PER_S,
    )
