"""A model family is found by name (``catalog.family``), and a family the
harness did not know comes as files alone.

The two families the benchmark has give what they gave before they were
looked up by name: each configuration's layout, its drawn weights, the
program's ``ModelConfig``, the reference loss and the model flops (the
values below were read from the code before it moved into
``portbench/families/``).  In a copy of ``portbench/``, a planted
``families/ssm.py`` with a configuration and a cell of its own runs the
CPU path to ``correct`` with no file of the copy edited, and a planted
fault is still refused there."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import catalog, program, weights  # noqa: E402
from portbench.arith import flops  # noqa: E402
from portbench.generator import TrainBatches  # noqa: E402
from portbench.reference import model  # noqa: E402
from portbench.reference.layout import leaves  # noqa: E402
from portbench.reference.train import nest  # noqa: E402

import portbench_small as small  # noqa: E402

SEED = 2**31 + 9
BEFORE = {
    "granite-20b-4l": {
        "batch": 2,
        "layout": ("8dcd04c7c476202a1ee16a34c8c2fb01cc94b0424a69cb0ae35e35f08a6dd489", 13),
        "weights": {
            "bfloat16": "0048ce308ff0f8b3463d136e1b16c51ef84e1fbc09501b5e6f9aeddcb1d81d51",
            "float32": "9654054930d9ecbc6a49a9cb9cc493df71047e5ffe2375ff804d65b439a547a9",
        },
        "loss": {"f32": "0x1.9704620000000p+2", "fp8": "0x1.96f5d00000000p+2"},
        "flops": 95146242736128,
        "params": 1_818_286_080,
    },
    "zamba2-1.2b": {
        "batch": 4,
        "layout": ("22ec37a6a1c3d5300de1e2b23b06159a001ea5dafa1b671abbfa193ea267aff3", 18),
        "weights": {
            "bfloat16": "a382e052153bfa321b59706a0a592bda0ca99d099205e240f292a24ef556baf9",
            "float32": "c58a96a4797833c8c8aaa15cde0274aa5c9bc6afa5f5f8095d54f8a4220b7f5c",
        },
        "loss": {"f32": "0x1.9419600000000p+2", "fp8": "0x1.92f5380000000p+2"},
        "flops": 145604504190976.0,
        "params": 1_088_000_128,
    },
}
# the keys the harness passed to ModelConfig before it read the fields
OLD_MODEL_KEYS = (
    "family", "n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab", "d_head", "qkv_bias",
    "act", "norm", "tie_embeddings", "ssm_state", "ssm_heads", "ssm_head_dim", "ssm_inner",
    "conv_k", "ssd_chunk", "attn_every", "window", "remat",
)
CONFIGS = list(BEFORE)


def _family(name):
    cfg = catalog.config(name)
    return cfg, catalog.family(cfg["family"])


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_has_not_moved(name):
    cfg, fam = _family(name)
    rows = [(p, tuple(leaf.shape), str(leaf.dtype), leaf.init, leaf.fan_in) for p, leaf in leaves(fam.layout(cfg))]
    assert (hashlib.sha256(repr(rows).encode()).hexdigest(), len(rows)) == BEFORE[name]["layout"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", CONFIGS)
def test_drawn_weights_have_not_moved(name, dtype):
    cfg = small.reduced(catalog.config(name), dtype)
    h = hashlib.sha256()
    for path, t in leaves(weights.make(cfg, SEED, "cpu")):
        h.update(path.encode())
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.uint8)).numpy().tobytes())
    assert h.hexdigest() == BEFORE[name]["weights"][dtype]


@pytest.mark.parametrize("name", CONFIGS)
def test_model_config_has_not_moved(name):
    cfg = catalog.config(name)
    ModelConfig = program._import()[0]
    old = ModelConfig(
        name=cfg["name"], param_dtype=torch.bfloat16, **{k: cfg[k] for k in OLD_MODEL_KEYS if k in cfg}
    )
    assert program.model_config(cfg) == old


def test_model_config_passes_every_field():
    cfg = dict(catalog.config("granite-20b-4l"), family="moe", n_experts=9, top_k=2, n_shared=1, d_expert=768,
               capacity_factor=2.0)
    mcfg = program.model_config(cfg)
    assert (mcfg.family, mcfg.n_experts, mcfg.top_k, mcfg.n_shared, mcfg.d_expert, mcfg.capacity_factor) == (
        "moe", 9, 2, 1, 768, 2.0,
    )
    assert mcfg.name == cfg["name"] and mcfg.param_dtype == torch.bfloat16


@pytest.mark.parametrize("precision", ["f32", "fp8"])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_loss_has_not_moved(name, precision):
    cfg = small.reduced(catalog.config(name))
    flat = {p: weights.draw(cfg, 11, p, "cpu") for p, _ in leaves(catalog.family(cfg["family"]).layout(cfg))}
    toks, labels = TrainBatches({"kind": "train", "batch": 2, "seq": 48, "zipf_a": 1.2}, cfg["vocab"], 3).batch(0)
    with torch.no_grad():
        got = model.loss(cfg, nest(flat), torch.from_numpy(toks), torch.from_numpy(labels), precision)
    assert float(got).hex() == BEFORE[name]["loss"][precision]


@pytest.mark.parametrize("name", CONFIGS)
def test_model_flops_have_not_moved(name):
    cfg, fam = _family(name)
    got = fam.model_flops(cfg, BEFORE[name]["batch"], 4096)
    assert repr(got) == repr(BEFORE[name]["flops"])
    assert flops.train_model_flops(cfg, BEFORE[name]["batch"], 4096) == got
    assert fam.param_count(cfg) == BEFORE[name]["params"] == program.model_config(cfg).param_count()


@pytest.mark.parametrize("name", ["no-such-family", "moe", "../configs/granite-20b-4l"])
def test_an_unknown_family_is_refused_by_name(name):
    with pytest.raises(catalog.Unknown, match="famil"):
        catalog.family(name)
    cfg = dict(catalog.config("granite-20b-4l"), family=name)
    for fn in (lambda: flops.train_model_flops(cfg, 1, 8), lambda: weights.make(cfg, 1, "cpu")):
        with pytest.raises(catalog.Unknown):
            fn()


# --- a family the harness did not know, planted in a copy -----------------

SSM_FAMILY = '''
"""The ssm family (mamba2): a stack of Mamba2 layers alone."""

from portbench.arith import flops
from portbench.reference import layout as L
from portbench.reference import model as M


def layout(cfg):
    c = L.sizes(cfg)
    return L.lm(c, {**L.norm_pair(c, "ln1", (c["n_layers"],)), "mamba": L.mamba2(c, (c["n_layers"],))})


def _stack(cfg, num, params, x):
    for i in range(cfg["n_layers"]):
        x = M.run(M.ssm_layer, cfg, num, M.layer_params(params["layers"], i), x)
    return x


def loss(cfg, params, tokens, labels, precision="f32"):
    return M.lm_loss(cfg, params, tokens, labels, precision, _stack)


def param_count(cfg):
    c = flops.full(cfg)
    return c["n_layers"] * (flops.mamba_params(c) + c["d_model"]) + flops.unembed_params(c) + c["d_model"]


def model_flops(cfg, batch, seq):
    c = flops.full(cfg)
    fwd, bwd = flops.ssd_ops(batch, seq, c["ssm_heads"], c["ssm_head_dim"], c["ssm_state"])
    return 6 * param_count(c) * batch * seq + c["n_layers"] * (fwd + bwd)


def small(cfg):
    return dict(cfg, d_model=64, vocab=500, n_layers=2, ssm_state=16, ssm_head_dim=16, ssm_inner=128,
                ssm_heads=8, ssd_chunk=16)
'''
ADAMW = catalog.config("granite-20b-4l")["adamw"]
SSM_CONFIG = {
    "name": "mamba2-130m", "source": "https://arxiv.org/abs/2405.21060", "reduced": [], "family": "ssm",
    "n_layers": 24, "d_model": 768, "n_heads": 0, "n_kv": 0, "d_ff": 0, "vocab": 50280, "act": "swiglu",
    "norm": "rms", "tie_embeddings": True, "ssm_state": 128, "ssm_head_dim": 64, "conv_k": 4, "ssd_chunk": 128,
    "remat": "full", "param_dtype": "bfloat16", "adamw": ADAMW,
}
SSM_CELL = {
    "name": "mamba2-130m.train-2x4k", "config": "mamba2-130m", "traffic": "train-2x4k", "chips": 1,
    "why": "a planted cell of a planted family", "trace_steps": 1,
    "limits": catalog.cell("granite-20b.train-2x4k")["limits"],
}
RUN_PLANTED = textwrap.dedent('''
    import json, sys, time
    sys.path[:0] = [sys.argv[1], sys.argv[1] + "/portbench/tests", sys.argv[2]]
    from portbench import catalog, program
    from portbench.arith import flops
    from portbench.drivers import train as drv
    from portbench_small import reduced

    assert catalog.__file__.startswith(sys.argv[1]), catalog.__file__
    cell = catalog.cell("mamba2-130m.train-2x4k")
    config = reduced(catalog.config(cell["config"]))
    mix = {"kind": "train", "batch": 2, "seq": 64, "zipf_a": 1.2}
    out = {"params": [flops.param_count(config), program.model_config(config).param_count()]}
    for fault in ("", "grad_doubled"):
        rec = drv.run(cell, config, mix, seed=2**31 + 4321, seconds=0.2, trace=False, device="cpu",
                      t0=time.perf_counter(), fault=fault)
        out[fault or "sound"] = {"correct": rec.correct, "checks": rec.checks, "flops": rec.flops_per_step}
    print(json.dumps(out))
''')


def _copy(tmp_path) -> pathlib.Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "portbench"


def _plant(bench: pathlib.Path, files: dict) -> None:
    for rel, text in files.items():
        assert not (ROOT / "portbench" / rel).exists(), rel
        (bench / rel).write_text(text if isinstance(text, str) else json.dumps(text))


def _unchanged(bench: pathlib.Path) -> None:
    for path in (ROOT / "portbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (bench / path.relative_to(ROOT / "portbench")).read_bytes() == path.read_bytes(), path


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_a_new_family_comes_as_files(tmp_path):
    bench = _copy(tmp_path)
    _plant(bench, {
        "families/ssm.py": SSM_FAMILY,
        "configs/mamba2-130m.json": SSM_CONFIG,
        "workloads/mamba2-130m.train-2x4k.json": SSM_CELL,
    })
    out = subprocess.run(
        [sys.executable, "-c", RUN_PLANTED, str(tmp_path), str(ROOT / "src")],
        cwd=tmp_path, capture_output=True, text=True, env=_env(), timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["params"][0] == got["params"][1]
    assert got["sound"]["correct"], got["sound"]["checks"]
    assert got["sound"]["flops"] > 0
    bad = got["grad_doubled"]
    assert not bad["correct"] and bad["checks"]["grad"]["value"] > bad["checks"]["grad"]["limit"], bad
    _unchanged(bench)


def test_a_cell_of_an_unknown_family_is_refused_by_name(tmp_path):
    bench = _copy(tmp_path)
    _plant(bench, {
        "configs/odd-2l.json": dict(SSM_CONFIG, name="odd-2l", family="odd"),
        "workloads/odd-2l.train-2x4k.json": dict(SSM_CELL, name="odd-2l.train-2x4k", config="odd-2l"),
    })
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "odd-2l.train-2x4k", "--seed", "7", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, env=_env(), timeout=300,
    )
    assert out.returncode == 2 and "{" not in out.stdout
    assert "'odd'" in out.stderr and "famil" in out.stderr
    _unchanged(bench)
