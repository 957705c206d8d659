"""Kernel dispatch layer: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The route follows the tensor's device and nothing else: there is no
override that sends a CUDA tensor to the plain path, and no interpret
mode (a CUDA kernel has none).  A ``meta`` tensor (the dry run's) takes
the plain version too, for its shapes alone: it computes nothing, as the
reference's dry run lowers ``backend="xla"``.  Ported: ``softmax``, ``row_reduce``,
``rmsnorm``, ``layernorm``, ``attention``, ``decode_attention`` and
``ssd_scan``: every kernel of the reference.  ``rmsnorm``, ``layernorm``,
``attention`` and ``ssd_scan`` are differentiable, with hand-written
backward kernels on the card and autograd through the plain versions on
the CPU.  ``topk_gate`` (the MoE router) is the plain version on every
device, as in the reference, which has no kernel for it.  AdamW's
kernels (``kernels/adamw.py``, which replace no TPU kernel) are called
by ``optim/adamw.py`` and counted here with the rest.
"""

from __future__ import annotations

import torch

from . import adamw as _adamw
from . import flash_attention as _fa
from . import norms as _norms
from . import ref as _ref
from . import softmax as _sm
from . import ssd_scan as _ssd
from . import warp_reduce as _wr


def resolve(x: torch.Tensor) -> str:
    """The route a tensor takes: ``"cuda"`` (the kernel), ``"torch"``
    (the plain version on the CPU) or ``"meta"`` (the plain version, for
    shapes only)."""
    route = {"cuda": "cuda", "cpu": "torch", "meta": "meta"}.get(x.device.type)
    if route is None:
        raise ValueError(f"no kernel route for device {x.device}")
    return route


def softmax(x: torch.Tensor) -> torch.Tensor:
    return _sm.softmax(x)


def row_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    return _wr.row_reduce(x, op)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _norms.rmsnorm(x, w, eps)


def layernorm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6):
    return _norms.layernorm(x, w, bias, eps)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, window: int = 0, scale=None
) -> torch.Tensor:
    """Batched: q (B, S, H, D), k/v (B, S, Hkv, D); logits scaled by
    ``scale``, ``1/sqrt(D)`` by default.  The reference's
    ``ops.attention`` takes one sequence and is vmapped over the batch
    (``layers.attention_apply``)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    return_lse: bool = False,
):
    """Batched: q (B, H, D), caches (B, S, Hkv, D), kv_len (B,) int32.  The
    reference's ``ops.decode_attention`` takes one sequence and is vmapped
    over the batch (``layers.attention_decode``).  ``return_lse`` adds each
    head's f32 log-sum-exp (B, H): ``(out, lse)``, for combining slabs of
    a sequence-sharded cache."""
    return _fa.flash_decode(q, k_cache, v_cache, kv_len, return_lse=return_lse)


def ssd_scan(
    x: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    chunk: int = _ssd.DEFAULT_CHUNK,
) -> torch.Tensor:
    """Batched: x (B, S, H, P), a (B, S, H), b and c (B, S, N).  The
    reference's ``ops.ssd_scan`` takes one sequence and is vmapped over the
    batch (``layers.mamba2_apply``)."""
    return _ssd.ssd_scan(x, a, b, c, chunk=chunk)


def topk_gate(logits: torch.Tensor, k: int):
    """(T, E) router logits -> ``(weights (T, k), indices (T, k))``."""
    return _ref.topk_gate(logits, k)


# each kernel's launch counter: (wrapper module, attribute)
_COUNTERS = {
    "softmax": (_sm, "launches"),
    "row_reduce": (_wr, "launches"),
    "rmsnorm": (_norms, "launches"),
    "rmsnorm_bwd": (_norms, "bwd_launches"),
    "layernorm": (_norms, "ln_launches"),
    "layernorm_bwd": (_norms, "ln_bwd_launches"),
    "flash_decode": (_fa, "decode_launches"),
    "flash_attention": (_fa, "fwd_launches"),
    "flash_attention_bwd": (_fa, "bwd_launches"),
    "ssd_scan": (_ssd, "launches"),
    "ssd_scan_bwd": (_ssd, "bwd_launches"),
    "adamw_sumsq": (_adamw, "launches"),
    "adamw_apply": (_adamw, "apply_launches"),
}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
