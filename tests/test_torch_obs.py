"""The port's span recorder (``repro_torch.obs``) on the CPU, around a
reduced granite-20b train step (``granite-20b-smoke``: 2 layers, layer
norms, MQA, the gelu MLP):

- an off span enters no ``record_function`` and records nothing;
- under ``torch.profiler`` the step records its timed spans (``obs.TIMED``
  less those of the layers granite does not have, :data:`OPENED`)
  nested as the code nests them, with one step id a step; every span,
  timed or not, is an event of the profiler, and only the timed ones are
  recorded;
- a reduced granite-4.0-h-small step (the hybrid_moe family) records all
  of ``obs.TIMED``: its ``model.mamba`` and ``model.moe`` spans in the
  blocks, and in each MoE block ``moe.experts`` with the counters of the
  rows its held experts computed (as device tensors or numbers, resolved
  by ``summary``);
- under ``remat="full"`` the backward records one recomputed
  ``model.block`` a layer, a child of ``train.backward``, also when the
  recompute runs on another thread (the autograd engine's, on a card);
- the buffer keeps the newest ``MAX_STEPS`` steps;
- recording changes no number of the step;
- ``chip_smoke.py``'s device summaries leave out the spans' device copies.

The card's part (device times, memory) is a ``cuda``-marked test.
"""

import collections
import dataclasses
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.models.params import init_params
from repro_torch.optim import adamw
from repro_torch.parallel import steps

# the timed spans a family's step opens: obs.TIMED less the spans of the
# layers it does not have
OPENED = {
    "granite": obs.TIMED - {"model.mamba", "model.moe", "moe.experts"},
    "hybrid_moe": obs.TIMED,
}
# spans a step opens that obs does not record (record_function alone), by
# layers: (per step, per layer, per layer again under remat)
UNTIMED = {
    "train.step": (1, 0, 0),
    "model.embed": (1, 0, 0),
    "model.head": (1, 0, 0),
    "model.attention": (0, 1, 1),
    "model.ffn": (0, 1, 1),
    "adamw.cast": (1, 0, 0),
    "adamw.norm": (1, 0, 0),
    "adamw.apply": (1, 0, 0),
}


@pytest.fixture(autouse=True)
def fresh_buffer():
    obs.reset()
    yield
    obs.reset()


def _setup(remat: str = "none", device: str = "cpu", **widths):
    cfg = dataclasses.replace(registry.get("granite-20b-smoke"), remat=remat, **widths)
    step, specs = steps.make_train_step(cfg)
    params = init_params(specs, torch.Generator(device=device).manual_seed(0), device)
    opt = adamw.init_state(params, adamw.AdamWConfig())
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 16), generator=g).to(device) for k in ("tokens", "labels")}
    return cfg, step, params, opt, batch


def _run(step, params, opt, batch, n: int):
    losses = []
    for _ in range(n):
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].clone())
    return params, losses


def _by_id(rows):
    return {r["id"]: r for r in rows}


def _parent_name(rows, r):
    p = _by_id(rows).get(r["parent"])
    return None if p is None else p["name"]


def test_off_span_enters_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert obs.span("train.step") is obs.span("model.block", layer=0)
    _, step, params, opt, batch = _setup()
    _run(step, params, opt, batch, 1)
    assert obs.summary() == {}


def test_recording_false_is_off_under_the_profiler():
    _, step, params, opt, batch = _setup()
    with profile(activities=[ProfilerActivity.CPU]), obs.recording(False):
        _run(step, params, opt, batch, 1)
    assert obs.summary() == {}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_profiled_step_records_nested_spans(remat):
    cfg, step, params, opt, batch = _setup(remat)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(step, params, opt, batch, 2)
    found = obs.summary()
    assert list(found) == [1, 2]
    for sid, rows in found.items():
        assert all(r["step"] == sid for r in rows)
        names = [r["name"] for r in rows]
        assert set(names) == OPENED["granite"]
        assert [names.count(n) for n in ("train.forward", "train.backward", "adamw.update")] == [1, 1, 1]
        for r in rows:
            assert r["host_ms"] >= 0 and r["device_ms"] is None and r["mem_delta"] is None
            if r["name"] != "model.block":
                assert _parent_name(rows, r) is None, r
        blocks = [r for r in rows if r["name"] == "model.block"]
        first = [r for r in blocks if not r["attrs"].get("recompute")]
        again = [r for r in blocks if r["attrs"].get("recompute")]
        assert [r["attrs"]["layer"] for r in first] == list(range(cfg.n_layers))
        assert all(_parent_name(rows, r) == "train.forward" for r in first)
        if remat == "full":
            assert len(again) == cfg.n_layers
            assert sorted(r["attrs"]["layer"] for r in again) == list(range(cfg.n_layers))
            assert all(_parent_name(rows, r) == "train.backward" for r in again)
        else:
            assert again == []
    # every span is also an event of the profiler: the timed ones as often
    # as they recorded, the others as often as the step opens them
    events = collections.Counter(e.name for e in prof.events() if e.name.startswith(obs.PREFIX))
    want = collections.Counter(obs.PREFIX + r["name"] for rows in found.values() for r in rows)
    recomputed = cfg.n_layers if remat == "full" else 0
    for name, (per_step, per_layer, per_recompute) in UNTIMED.items():
        want[obs.PREFIX + name] = len(found) * (per_step + per_layer * cfg.n_layers + per_recompute * recomputed)
    assert events == want


def test_recording_without_a_profiler():
    _, step, params, opt, batch = _setup()
    with obs.recording():
        _run(step, params, opt, batch, 1)
    (rows,) = obs.summary().values()
    assert {r["name"] for r in rows} == OPENED["granite"]
    assert all(r["counters"] == {} for r in rows)


def _hybrid_moe_setup(remat: str = "full"):
    from repro_torch.configs import granite_4_0_h_small

    cfg = dataclasses.replace(
        granite_4_0_h_small.CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv=2, d_head=16, vocab=500,
        d_expert=32, shared_intermediate_size=48, n_experts=16, experts_held=4, top_k=4, ssm_state=16,
        ssm_heads=8, ssm_head_dim=16, ssm_inner=128, ssd_chunk=16, remat=remat, param_dtype=torch.float32,
    )
    step, specs = steps.make_train_step(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    opt = adamw.init_state(params, adamw.AdamWConfig())
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 32), generator=g) for k in ("tokens", "labels")}
    return cfg, step, params, opt, batch


@pytest.mark.parametrize("remat", ["none", "full"])
def test_hybrid_moe_step_records_its_spans_and_counters(remat):
    cfg, step, params, opt, batch = _hybrid_moe_setup(remat)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(step, params, opt, batch, 1)
    (rows,) = obs.summary().values()
    assert {r["name"] for r in rows} == OPENED["hybrid_moe"]
    again = 2 if remat == "full" else 1
    mixers = [r for r in rows if r["name"] == "model.mamba"]
    moes = [r for r in rows if r["name"] == "model.moe"]
    experts = [r for r in rows if r["name"] == "moe.experts"]
    assert len(mixers) == again * cfg.pattern().count("mamba")
    assert len(moes) == len(experts) == again * cfg.n_layers
    assert all(_parent_name(rows, r) == "model.block" for r in mixers + moes)
    assert all(_parent_name(rows, r) == "model.moe" for r in experts)
    T = batch["tokens"].numel()
    for r in experts:
        c = r["counters"]
        assert set(c) == {"rows", "max_rows"} and 0 < c["max_rows"] <= c["rows"] <= T * cfg.top_k
    if remat == "full":  # the recompute routes the same tokens to the same experts
        first = [r["counters"] for r in experts if not r["attrs"].get("recompute")]
        redo = sorted((r["counters"]["rows"], r["counters"]["max_rows"]) for r in experts if r["attrs"].get("recompute"))
        assert redo == sorted((c["rows"], c["max_rows"]) for c in first)
    routes = sum(e.name == obs.PREFIX + "moe.route" for e in prof.events())
    assert routes == again * cfg.n_layers  # a trace-only span


def test_count_adds_to_the_innermost_timed_span():
    with obs.recording():
        obs.count(rows=1)  # no span open: nothing
        obs.next_step()
        with obs.span("model.moe"):
            with obs.span("moe.experts"):
                obs.count(rows=3, max_rows=2)
                obs.count(rows=torch.tensor(4), max_rows=torch.tensor(1.5))
            obs.count(rows=7)
    rows = obs.summary()[1]
    by = {r["name"]: r["counters"] for r in rows}
    assert by == {"model.moe": {"rows": 7}, "moe.experts": {"rows": 7, "max_rows": 3.5}}
    assert isinstance(by["moe.experts"]["rows"], int)
    obs.reset()
    obs.count(rows=1)  # spans off: nothing, no error
    assert obs.summary() == {}


def test_an_untimed_span_is_a_record_function_alone(monkeypatch):
    entered = []

    class Marker:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    with obs.recording():  # on, but no profiler: nothing to mark
        assert obs.span("model.ffn") is obs.span("adamw.cast")
    monkeypatch.setattr(torch.profiler, "record_function", Marker)
    with profile(activities=[ProfilerActivity.CPU]):
        obs.next_step()
        with obs.span("model.ffn"), obs.span("train.forward"):
            pass
    assert entered == [obs.PREFIX + "model.ffn", obs.PREFIX + "train.forward"]
    assert [r["name"] for r in obs.summary()[1]] == ["train.forward"]


def test_a_span_on_another_thread_joins_the_open_backward():
    seen = {}

    def engine():
        with obs.span("model.block", layer=3) as s:
            seen["parent"] = s.parent.name if s.parent else None
        with obs.span("model.block", layer=4):
            pass

    with obs.recording():
        obs.next_step()
        with obs.span("train.backward"):
            t = threading.Thread(target=engine)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        with obs.span("model.block", layer=5):  # the backward has closed
            pass
    rows = obs.summary()[1]
    blocks = [r for r in rows if r["name"] == "model.block"]
    assert seen["parent"] == "train.backward"
    assert [r["attrs"] for r in blocks] == [
        {"layer": 3, "recompute": True},
        {"layer": 4, "recompute": True},
        {"layer": 5},
    ]
    assert [_parent_name(rows, r) for r in blocks] == ["train.backward", "train.backward", None]


def test_buffer_keeps_the_newest_steps():
    n = 3 * obs.MAX_STEPS
    with obs.recording():
        for _ in range(n):
            obs.next_step()
            with obs.span("train.forward"):
                with obs.span("model.block", layer=0):
                    pass
    found = obs.summary()
    assert list(found) == list(range(n - obs.MAX_STEPS + 1, n + 1))
    assert all(len(rows) == 2 for rows in found.values())
    assert list(obs.summary(last_steps=2)) == [n - 1, n]
    assert obs.summary(last_steps=0) == {}


def test_recording_changes_no_number():
    outs = []
    for on in (False, True):
        _, step, params, opt, batch = _setup("full")
        with obs.recording(on):
            params, losses = _run(step, params, opt, batch, 2)
        outs.append((params, losses))
    (p_off, l_off), (p_on, l_on) = outs
    assert obs.summary()  # the second pass did record
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    flat_off = torch.cat([t.flatten() for t in _leaves(p_off)])
    flat_on = torch.cat([t.flatten() for t in _leaves(p_on)])
    assert torch.equal(flat_off, flat_on)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_chip_smoke_device_summary_leaves_out_span_copies():
    import chip_smoke
    from torch.autograd import DeviceType

    def avg(key, us, device=DeviceType.CUDA, annotation=False):
        return types.SimpleNamespace(
            key=key, self_device_time_total=us, count=2, device_type=device, is_user_annotation=annotation
        )

    events = [
        avg("nvjet_tst_192x192_NNN", 3000.0),
        avg("flash_tc::fwd_kernel", 1000.0),
        avg("repro_torch.train.forward", 5000.0, annotation=True),
        avg("repro_torch.model.block", 4500.0),  # flagged or not, a span's copy is no operation
        avg("portbench.fwd_bwd", 6000.0, annotation=True),
        avg("aten::mm", 0.0, device=DeviceType.CPU),
    ]
    got = chip_smoke._device_summary(types.SimpleNamespace(key_averages=lambda: events), wall=0.008)
    assert got["device_busy_ms"] == pytest.approx(4.0)
    assert got["device_idle_share"] == pytest.approx(0.5)
    assert got["device_ops"] == 4
    assert set(got["top_device_ms"]) == {"nvjet_tst_192x192_NNN", "flash_tc::fwd_kernel"}


@pytest.mark.cuda
def test_device_times_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import build

    build.build_all()
    cfg, step, params, opt, batch = _setup("full", device="cuda", d_head=64)  # a head the kernels take
    _run(step, params, opt, batch, 1)  # warm up
    with obs.recording():
        _run(step, params, opt, batch, 2)
    for rows in obs.summary().values():
        by = {r["name"]: r for r in rows}
        assert all(r["device_ms"] > 0 for r in rows)
        assert by["train.forward"]["mem_delta"] > 0
        assert all(r["mem_delta"] is None for r in rows if r["name"] not in obs.MEMORY)
        blocks = [r for r in rows if r["name"] == "model.block"]
        first = [r["device_ms"] for r in blocks if not r["attrs"].get("recompute")]
        again = [r["device_ms"] for r in blocks if r["attrs"].get("recompute")]
        assert len(first) == len(again) == cfg.n_layers
        assert sum(first) < by["train.forward"]["device_ms"]
        assert sum(again) < by["train.backward"]["device_ms"]
