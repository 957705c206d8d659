"""The port's end-to-end cases: ``tests/test_system.py`` held in the port
and against the JAX package on the CPU.

Each ``examples/torch_<name>.py`` runs with ``--device cpu`` and its
returned arrays are held against the reference example's own kernels and
entry points:

- quickstart (:4): the launch is bitwise the port's oracle and the
  reference's launch; ``summary()`` is the reference's; flat collapsing
  is refused with the reference's exception type;
- cuda_migration (:9): both copies and the dim3 transpose bitwise;
- the three-way softmax (:14) at the example's tolerance;
- graph_replay and streams_overlap at ``--iters 2``: within the port a
  replay is bitwise the eager launches and two streams bitwise serial
  issue (the examples assert it); against the reference's kernels at
  rtol = atol = 1e-5, because XLA's CPU contracts ``2.5 * x + y`` into a
  fused multiply-add where eager torch rounds twice (ROADMAP C.4);
- serving end to end (:19) and with the replayed token pipeline (:27):
  the reference's assertions, and the counts against the reference's
  ``serve_requests`` on the same carried weights, its server on the
  Auto-axes mesh (``_carried_serve_requests``, as in
  ``test_torch_serve``, with every family's weights; ROADMAP C.2);
- the batched prefill (:39): the port's prefill equals its own
  token-by-token path, positions included, and the reference server's
  tokens on the same weights;
- ``torch_train_lm`` at mamba2-130m-smoke: its losses are bitwise those
  of ``train`` called directly, and within ``test_torch_train``'s loss
  tolerance of the reference's ``train`` from the same weights;
- the served greedy argmax never picks a padded vocabulary column
  (granite-moe's 49,155 of 49,408), on one device and vocab-sharded over
  two gloo ranks; the reference's ``jnp.argmax`` takes every column
  (ROADMAP C.4).

Every example raises where there is no card and no device is given; the
``cuda``-marked cases run each example on the card.
"""

import dataclasses
import importlib
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cox as rcox
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro_torch.configs import registry as preg
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.models import carry
from repro_torch.models import lm as plm
from repro_torch.models.params import init_params
from repro_torch.optim import adamw as padamw
from repro_torch.parallel import steps as psteps
from torch_models import as_jax, auto_mesh, configs, jax_weights, servers

EXAMPLES = (
    "quickstart",
    "cuda_migration",
    "cox_kernels_in_models",
    "graph_replay",
    "streams_overlap",
    "serve_batched",
    "train_lm",
)
SSM = "mamba2-130m-smoke"
FMA_TOL = dict(rtol=1e-5, atol=1e-5)


def port_example(name):
    return importlib.import_module(f"examples.torch_{name}")


def ref_example(name):
    return importlib.import_module(f"examples.{name}")


def test_quickstart_example():
    got = port_example("quickstart").main(["--device", "cpu"])
    q = ref_example("quickstart")
    val = np.arange(256, dtype=np.float32)
    out0 = np.zeros(1, np.float32)
    want = np.asarray(q.warp_reduce.launch(grid=1, block=256, args=(out0, val))["out"])
    np.testing.assert_array_equal(got["out"], got["oracle"])
    np.testing.assert_array_equal(got["out"], want)
    assert got["out"][0] == val[:32].sum()
    assert got["summary"] == q.warp_reduce.compiled(collapse="hier").summary()
    with pytest.raises(Exception) as refused:
        q.warp_reduce.launch(grid=1, block=256, args=(out0, val), collapse="flat")
    assert got["flat_error"] == type(refused.value).__name__ == "FlatUnsupported"


def test_cuda_migration_example():
    got = port_example("cuda_migration").main(["--device", "cpu"])
    h_a = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    h_m = np.random.default_rng(1).normal(size=(64, 64)).astype(np.float32)
    np.testing.assert_array_equal(got["h_a"], h_a)
    np.testing.assert_array_equal(got["vec_copy"], h_a)
    np.testing.assert_array_equal(got["vec_copy_normal"], h_a)
    np.testing.assert_array_equal(got["transpose"], h_m.T)
    # the reference example's kernels on the same inputs
    m = ref_example("cuda_migration")
    want = m.mat_transpose.launch(grid=(4, 4), block=(16, 16), args=(np.zeros((64, 64), np.float32), h_m, 64))
    np.testing.assert_array_equal(got["transpose"], np.asarray(want["odata"]))


def test_three_way_kernel_agreement():
    got = port_example("cox_kernels_in_models").main(["--device", "cpu"])
    x = np.random.default_rng(0).normal(size=(8, 128)).astype(np.float32)
    k = ref_example("cox_kernels_in_models")
    want = np.asarray(k.ref.softmax(jnp.asarray(x)))
    ref_cox = np.asarray(k.softmax_rows.launch(grid=4, block=64, args=(np.zeros_like(x), x, 128))["out"])
    for leg in ("cox", "kernel", "ref"):
        np.testing.assert_allclose(got[leg], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["cox"], ref_cox, rtol=1e-4, atol=1e-5)


def _chain_inputs():
    grid, block = 32, 256
    n = grid * block
    x = np.arange(n, dtype=np.float32) / n
    return grid, block, n, x, np.ones(n, np.float32), np.zeros(n, np.float32)


def test_graph_replay_example():
    got = port_example("graph_replay").main(["--device", "cpu", "--iters", "2"])
    np.testing.assert_array_equal(got["replay"], got["eager"])
    assert got["eager_ms"] > 0 and got["replay_ms"] > 0 and not got["cuda_graph"]
    # the reference example's capture, replay and rebound replay
    g_mod = ref_example("graph_replay")
    grid, block, n, x, y, o = _chain_inputs()
    s = rcox.Stream("capture")
    g = rcox.Graph(name="saxpy-scale")
    with g.capture(s):
        h1 = s.launch(g_mod.saxpy, grid=grid, block=block, args=(o, x, y, n))
        s.launch(g_mod.scale, grid=grid, block=block, args=(o, h1.outputs["out"], n))
    exe = g.instantiate()
    want = np.asarray(exe.replay()["out"])
    want_rebound = np.asarray(exe.replay(x=x[::-1].copy())["out"])
    np.testing.assert_allclose(got["replay"], want, **FMA_TOL)
    np.testing.assert_allclose(got["rebound"], want_rebound, **FMA_TOL)


def test_streams_overlap_example():
    got = port_example("streams_overlap").main(["--device", "cpu", "--iters", "2"])
    assert got["serial_ms"] > 0 and got["stream_ms"] > 0 and got["event_ms"] >= 0
    np.testing.assert_array_equal(got["chained"], got["saxpy"] * 3.0 + 1.0)
    # the reference example's kernels, issued serially
    s_mod = ref_example("streams_overlap")
    grid, block, n, x, y, o = _chain_inputs()
    ref1 = np.asarray(s_mod.saxpy.launch(grid=grid, block=block, args=(o, x, y, n))["out"])
    ref2 = np.asarray(s_mod.scale.launch(grid=grid, block=block, args=(o, x, n))["out"])
    np.testing.assert_allclose(got["saxpy"], ref1, **FMA_TOL)
    np.testing.assert_array_equal(got["scale"], ref2)  # x * 3 + 1 is exact on these inputs
    np.testing.assert_allclose(got["chained"], ref1 * 3.0 + 1.0, **FMA_TOL)


def _carried_serve_requests(monkeypatch, arch=SSM, seed=10):
    """Both packages' ``serve_requests`` build their servers on the same
    carried weights (the reference's on the Auto-axes mesh)."""
    cj, cp = configs(arch)
    tree = jax_weights(cj, seed=seed)
    jcls, pcls = jserve.BatchedServer, pserve.BatchedServer
    monkeypatch.setattr(
        jserve, "BatchedServer", lambda a, **kw: jcls(a, params=as_jax(tree), mesh=auto_mesh(), **kw)
    )
    monkeypatch.setattr(
        pserve, "BatchedServer", lambda a, **kw: pcls(a, params=carry.from_jax_params(cp, tree, "cpu"), **kw)
    )


def test_serve_batched_end_to_end(monkeypatch):
    kw = dict(batch=2, ctx=64, n_requests=3, max_tokens=8)
    out = pserve.serve_requests(SSM, device="cpu", **kw)
    assert out["completed"] >= 3
    assert out["tokens"] > 0
    # the example's CLI drives the same entry point
    cli = port_example("serve_batched").main(
        ["--batch", "2", "--ctx", "64", "--requests", "3", "--tokens", "8", "--device", "cpu"]
    )
    assert (cli["completed"], cli["tokens"]) == (out["completed"], out["tokens"])
    # against the reference's serve_requests on the same carried weights
    _carried_serve_requests(monkeypatch)
    want = jserve.serve_requests(SSM, **kw)
    got = pserve.serve_requests(SSM, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])


def test_serve_graph_replay_matches_eager(monkeypatch):
    """--graph captures the per-token stats pipeline once and replays it
    every decode step; serve_requests itself asserts the replayed
    statistics are bitwise the shadow eager pipeline's."""
    kw = dict(batch=2, ctx=64, n_requests=2, max_tokens=6, graph=True)
    out = pserve.serve_requests(SSM, device="cpu", **kw)
    assert out["graph"]["replayed"]
    assert out["graph"]["steps"] > 1  # captured once, replayed
    assert out["graph"]["hist_tokens"] == out["tokens"]
    _carried_serve_requests(monkeypatch)
    want = jserve.serve_requests(SSM, **kw)
    got = pserve.serve_requests(SSM, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])
    for k in ("steps", "hist_tokens", "replayed"):
        assert got["graph"][k] == want["graph"][k], k


PROMPTS = {0: [5, 9, 2, 7], 1: [11, 3, 8, 1]}


def _token_by_token(server):
    """The old prefill: one decode step a prompt token."""
    for slot, prompt in PROMPTS.items():
        server.pos[slot] = 0
        server.outputs[slot] = []
        server.active[slot] = True
        for t in prompt:
            server.tokens[slot] = t
            server._step_all()
        server.tokens[slot] = prompt[-1]
    return server.decode(8)


def _batched(server):
    for slot, prompt in PROMPTS.items():
        server.prefill_prompt(slot, prompt)
    return server.decode(8)


def test_batched_prefill_matches_token_by_token():
    """prefill_prompt consumes the whole prompt; the decode output after
    it equals stepping the prompt through the decode path one token at a
    time, positions included; and the reference server's, on the same
    weights."""
    a = pserve.BatchedServer(SSM, batch=2, ctx=64, seed=3, device="cpu")
    b = pserve.BatchedServer(SSM, batch=2, ctx=64, seed=3, device="cpu")
    ref, new = _token_by_token(a), _batched(b)
    assert ref == new  # exact token match
    assert all(len(o) > 0 for o in new)
    assert np.array_equal(a.pos, b.pos)
    js, ps = servers(SSM, batch=2, ctx=64, seed=3)
    want, got = _batched(js), _batched(ps)
    assert got == want
    assert np.array_equal(ps.pos, js.pos)


TRAIN_ARGV = ["--arch", SSM, "--steps", "4", "--batch", "2", "--seq", "32", "--ckpt-every", "2"]


def test_train_lm_example(tmp_path, monkeypatch):
    """The example's losses are bitwise ``train``'s with the same
    arguments; from carried weights they are within 1e-5 of the
    reference's ``train`` (``test_torch_train``'s loss tolerance), whose
    mesh is the Auto-axes one."""
    ex = port_example("train_lm")
    got = ex.main(TRAIN_ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "example")])
    opt = padamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=4)
    direct = ptrain.train(
        SSM, steps=4, batch=2, seq=32, ckpt_dir=str(tmp_path / "direct"), ckpt_every=2,
        log_every=20, opt_cfg=opt, device="cpu",
    )
    assert got["losses"] == direct["losses"] and len(got["losses"]) == 4
    assert sorted(p.name for p in (tmp_path / "example").iterdir()) == sorted(
        p.name for p in (tmp_path / "direct").iterdir()
    )
    # the same run from weights carried into both packages
    cj, cp = configs(SSM)
    tree = jax_weights(cj, seed=5)
    monkeypatch.setattr(jtrain, "init_params", lambda specs, key: as_jax(tree))
    want = jtrain.train(
        SSM, steps=4, batch=2, seq=32, ckpt_dir=str(tmp_path / "ref"), ckpt_every=2, mesh=auto_mesh(),
        log_every=20, opt_cfg=jadamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=4),
    )
    plain = ex.train
    monkeypatch.setattr(ex, "train", lambda *a, **kw: plain(*a, params=carry.from_jax_params(cp, tree, "cpu"), **kw))
    carried = ex.main(TRAIN_ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "carried")])
    np.testing.assert_allclose(carried["losses"], want["losses"], rtol=1e-5)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want["params"]):
        key = [k.key for k in path]
        t = carried["params"]
        for k in key:
            t = t[k]
        assert t.shape == tuple(leaf.shape), key


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_raise_without_a_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_example(name).main(argv)


CARD_ARGV = {
    "graph_replay": ["--iters", "5"],
    "streams_overlap": ["--iters", "5"],
    "serve_batched": ["--requests", "4"],
    "train_lm": TRAIN_ARGV,
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_on_the_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    argv = CARD_ARGV.get(name, []) + (["--ckpt-dir", str(tmp_path)] if name == "train_lm" else [])
    out = port_example(name).main(argv)
    assert isinstance(out, dict)
    if name == "graph_replay":
        assert out["cuda_graph"]


def test_served_tokens_never_index_a_padded_column():
    """granite-moe-1b-a400m's vocabulary of 49,155 is padded to 49,408
    columns; the server's greedy argmax takes the vocabulary's columns
    alone.  Here the smoke twin's vocabulary is cut to 500 (512 columns)
    and the padded columns' unembedding is made large, so that they hold
    the largest logits of most rows."""
    cfg = dataclasses.replace(preg.get("granite-moe-1b-a400m", smoke=True), vocab=500)
    step, specs = psteps.make_serve_step(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    emb = params["embed"]
    assert tuple(emb["tok"].shape) == (512, cfg.d_model)
    with torch.no_grad():
        if "unembed" in emb:
            emb["unembed"][:, 500:] = 10.0
        else:
            emb["tok"][500:] = 10.0
    cache = init_params(plm.cache_specs(cfg, 4, 16), None, "cpu")
    toks, pos = torch.tensor([1, 2, 3, 4], dtype=torch.int32), torch.tensor([0, 3, 5, 9], dtype=torch.int32)
    logits, _ = plm.decode_step(cfg, params, dict(cache), toks, pos)
    assert (logits.argmax(-1) >= 500).sum() >= 2  # unmasked, the padding would win
    nxt, _ = step(params, cache, toks, pos)
    assert (nxt < 500).all()
    assert torch.equal(nxt, logits[:, :500].argmax(-1).to(torch.int32))


ARGMAX_RANK = '''
import sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.models import layers
from repro_torch.models.params import default_rules

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
logits = torch.randn(4, 512, generator=torch.Generator().manual_seed(0))
logits[1:, 500:] = 100.0  # the padding would win rows 1-3
z = distribute_tensor(logits, mesh, [Replicate(), Shard(1)])
got = layers.argmax(z, 500, default_rules(mesh, "tp"))
assert torch.equal(got, logits[:, :500].argmax(-1).to(torch.int32)), got
print("rank", rank, "ok", got.tolist())
dist.destroy_process_group()
'''


def test_sharded_argmax_skips_the_padded_columns(tmp_path):
    """The vocab-sharded argmax of a served step (two gloo ranks, the
    padded columns all on rank 1) takes the vocabulary's columns alone."""
    script = tmp_path / "rank.py"
    script.write_text(ARGMAX_RANK)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = {**os.environ, "PYTHONPATH": str(pathlib.Path(__file__).resolve().parents[1] / "src")}
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), port], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "ok" in out
