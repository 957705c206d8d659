"""The frozen yardstick: model flops as PR 29's final run logged them, the
kernel bounds of ``PERF.md`` section 6, and the trace reduction."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import catalog  # noqa: E402
from portbench.arith import flops  # noqa: E402
from portbench.arith.trace import ATTENTION, GEMM, OTHER, SPAN_PREFIX, STEP_SPAN, Trace, kernel_kind  # noqa: E402


@pytest.mark.parametrize(
    "config, batch, tflop, params",
    [("granite-20b-4l", 2, 95.146242736128, 1_818_286_080), ("zamba2-1.2b", 4, 145.604504190976, 1_088_000_128)],
)
def test_train_model_flops_as_logged(config, batch, tflop, params):
    cfg = catalog.config(config)
    assert flops.param_count(cfg) == params
    assert flops.train_model_flops(cfg, batch, 4096) / 1e12 == pytest.approx(tflop, rel=1e-12)


def test_kernel_bounds_as_in_perf_md():
    fwd, bwd = flops.attention_bound_s(2, 4096, 48, 1, 128)
    assert (fwd * 1e3, bwd * 1e3) == pytest.approx((0.4170, 1.043), abs=5e-4)
    fwd, bwd = flops.ssd_bound_s(8, 4096, 24, 64, 128)
    assert (fwd * 1e3, bwd * 1e3) == pytest.approx((0.1728, 0.3781), abs=5e-5)
    assert flops.visible_pairs(4096, True, 4096) == flops.visible_pairs(4096, True, 0)
    assert flops.visible_pairs(8, True, 3) == 3 * 4 // 2 + 5 * 3


def test_kernel_kinds():
    assert kernel_kind("void flash_tc::fwd_kernel<128>") == ATTENTION
    assert kernel_kind("sm90_xmma_gemm_bf16bf16_bf16f32") == GEMM
    assert kernel_kind("nvjet_hsh_128x256") == GEMM
    assert kernel_kind("void at::native::vectorized_elementwise_kernel") == OTHER


def test_trace_reduction():
    spans = [
        (STEP_SPAN, 0.0, 100.0),
        (SPAN_PREFIX + "fwd_bwd", 0.0, 60.0),
        (SPAN_PREFIX + "adamw", 60.0, 90.0),
        (SPAN_PREFIX + "loss_read", 90.0, 100.0),
    ]
    ops = [
        ("gemm_a", 5.0, 30.0),
        ("flash_tc::fwd_kernel", 25.0, 50.0),  # overlaps the GEMM by 5 us
        ("elementwise", 65.0, 85.0),
    ]
    tr = Trace(ops, spans)
    assert tr.window_s() == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(65e-6)
    assert tr.busy_in_spans_s(SPAN_PREFIX + "fwd_bwd") == pytest.approx(45e-6)
    assert tr.busy_in_spans_s(SPAN_PREFIX + "adamw") == pytest.approx(20e-6)
    assert tr.kind_s()[GEMM] == pytest.approx(25e-6)
    assert tr.kind_s(SPAN_PREFIX + "fwd_bwd").get(OTHER, 0.0) == 0.0
    gaps = dict(tr.idle_gaps())
    assert gaps[SPAN_PREFIX + "fwd_bwd"] == pytest.approx(15e-6)  # 0-5 and 50-60
    assert gaps[SPAN_PREFIX + "adamw"] == pytest.approx(10e-6)  # 60-65 and 85-90
    assert gaps[SPAN_PREFIX + "loss_read"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(tr.window_s() - tr.busy_s())
    assert tr.device_ops()[0][0].startswith(GEMM)
    json.dumps({"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()})
