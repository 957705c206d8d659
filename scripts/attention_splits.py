#!/usr/bin/env python3
"""The bf16 attention backward against its dK/dV split count, on one CUDA card.

    python3 scripts/attention_splits.py

At granite-20b's train layer (B 2, S 4,096, 48 query heads over 1 kv head
of 128, causal) the dK/dV grid has 128 blocks, under one wave; the wrapper
splits each kv head's 48 query heads over ``dkdv_splits`` blocks.  This
times the backward (``flash_attention_bwd_cuda``: delta, dK/dV with its
split sum, dQ) for every split count that divides 48, with qwen2.5-14b's
backward (40/8 heads, no split) timed beside it in turns, in two rounds:
CUDA events around batches of calls, the median.  It prints one JSON
object per line, then the card's name and power limit.
"""

import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import flash_attention as fa  # noqa: E402

B, S, D = 2, 4096, 128


def median_ms(fn, batches: int = 7, calls: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def backward_inputs(gen, H: int, Hkv: int) -> tuple:
    """q, k, v, o, lse, dO as the backward takes them, bf16."""
    q = (0.5 * torch.randn(B, S, H, D, generator=gen, device="cuda")).bfloat16()
    k = (0.5 * torch.randn(B, S, Hkv, D, generator=gen, device="cuda")).bfloat16()
    v = (0.5 * torch.randn(B, S, Hkv, D, generator=gen, device="cuda")).bfloat16()
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
    o, lse = fa.flash_attention_cuda(q, k, v)
    return q, k, v, o, lse, do


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    qwen = backward_inputs(gen, 40, 8)
    mqa = backward_inputs(gen, 48, 1)
    chosen = fa.dkdv_splits(B, S, 1, 48, mqa[0].device)
    picker = fa.dkdv_splits
    try:
        for rnd in range(2):
            for n in [d for d in range(1, 49) if 48 % d == 0]:
                fa.dkdv_splits = lambda *args, n=n: n
                mqa_ms = median_ms(lambda: fa.flash_attention_bwd_cuda(*mqa))
                fa.dkdv_splits = picker
                qwen_ms = median_ms(lambda: fa.flash_attention_bwd_cuda(*qwen))
                rec = {"round": rnd, "splits": n, "chosen": n == chosen,
                       "mqa_bwd_ms": mqa_ms, "qwen_bwd_ms": qwen_ms}
                print(json.dumps(rec), flush=True)
    finally:
        fa.dkdv_splits = picker
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
