"""The model stack on a mesh (ROADMAP A.10.2): the port's sharded layers,
train and serve steps, ZeRO-1/2 and elastic checkpoints against the JAX
package's mesh paths and against the port's own one-device paths.

* **Worlds of processes** (``tests/torch_mesh_worker.py``), started
  together by one module-scoped fixture, each with a timeout of its own:
  the reference on 8 and on 4 XLA host devices (meshes with Auto axes,
  ROADMAP C.2), the port on 8 and on 4 gloo ranks, and 2 ranks whose
  collectives go through ``parallel/host_staged.py`` (the path gloo ranks
  take on a card).  The cases of ``tests/test_multidevice.py`` (:85 the
  expert-parallel MoE on 2 x 4, :106 the train step on 2 x 4) and their
  extensions: a capacity that drops tokens, both strategies,
  ``grad_compress``, a mamba2 step on (2, 1), the server on (1, 2) and
  (2, 2), a checkpoint saved on (2, 2) and restored elsewhere, and the
  collectives of a layer and of a decode step.
* **In this process**: ``tests/test_model_parts.py``'s
  ``test_head_padding_exactness`` (:85) and
  ``test_moe_shard_map_path_matches_local`` (:44), the split decode
  combined by log-sum-exp, and the SSM, hybrid and encoder-decoder
  families on a (1, 1) mesh, bitwise their one-device paths.
* **Tensor parallelism for the SSM, hybrid and encoder-decoder
  families**, in worlds 8 (decode steps) and 4: decode steps, train steps (ZeRO-1/2), servers
  and restores against the reference on the same mesh (XLA host devices,
  Auto axes) and against the port without a mesh; the reference runs all
  three families on these meshes, so nothing falls back to its
  one-device output.

Tolerances: the MoE at the reference's 2e-4; the loss within 1e-5 and the
grad norm within 1e-4 (relative); each updated parameter's change within
1e-3 of the largest change of its leaf (C.4's sign-like first steps are
smoothed by ``eps = 1e-2``); the served tokens equal; a decode step's logits and cache leaves within
1e-4 of each leaf's largest value against the reference (1e-5 against
the port without a mesh).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import torch_mesh_worker as W
from repro.configs import registry as jreg
from repro.models import layers as jL
from repro_torch.configs import registry as preg
from repro_torch.kernels import ref as pref
from repro_torch.launch import serve as pserve
from repro_torch.models import encdec as pencdec
from repro_torch.models import layers as pL
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams
from torch_suite import one_rank_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = str(pathlib.Path(__file__).with_name("torch_mesh_worker.py"))
# each world, alone ~100 s; its processes share the host's cores with the
# rest of the suite, and a reference world has taken over 240 s there
SPAWN_TIMEOUT_S = 420


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start every world at once; return ``{world: (dir, failures)}``."""
    procs, dirs = [], {}
    for world, n, ref, staged in ((8, 8, True, False), (4, 4, True, False), ("staged", 2, False, True)):
        d = tmp_path_factory.mktemp(f"mesh{world}")
        dirs[world] = d
        if ref:
            cmd = [sys.executable, WORKER, "ref", "--devices", str(n), "--out", str(d)]
            procs.append((world, "reference", cmd, _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")))
        for r in range(n):
            cmd = [sys.executable, WORKER, "rank", "--rank", str(r), "--world", str(n), "--out", str(d)]
            procs.append((world, f"rank {r}", cmd + (["--staged"] if staged else []), _env()))
    running = []
    for world, what, cmd, env in procs:
        log = open(dirs[world] / f"{what.replace(' ', '')}.log", "w+")
        p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        running.append((world, what, p, log))
    failures = {w: [] for w in dirs}
    for world, what, p, log in running:
        try:
            rc = p.wait(timeout=SPAWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, _, q, _ in running:
                q.kill()
            rc = "timeout"
        if rc != 0:
            log.seek(0)
            failures[world].append(f"{what} ({rc}):\n{log.read()[-3000:]}")
        log.close()
    return {w: (dirs[w], failures[w]) for w in dirs}


def _load(worlds, world, case, side):
    d, failures = worlds[world]
    assert not failures, "\n".join(failures)
    return dict(np.load(d / f"{case}.{side}.npz", allow_pickle=False))


def close_to_scale(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# worlds of processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["moe_ep", "moe_drop"])
def test_moe_ep_on_2x4_mesh(worlds, case):
    """Expert parallelism on 2 x 4 gloo ranks against the reference's
    2 x 4 mesh (``test_multidevice.py:85``); without drops also against
    the port's local path.  With capacity_factor 0.5 the slabs drop
    tokens, as the reference's do."""
    port, ref = _load(worlds, 8, case, "port"), _load(worlds, 8, case, "ref")
    np.testing.assert_allclose(port["y"], ref["y"], rtol=2e-4, atol=2e-4)
    if case == "moe_ep":
        np.testing.assert_allclose(port["y"], port["local"], rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(port["y"] - port["local"]).max() > 1e-3  # tokens were dropped


def _check_train(port, ref=None):
    for other, loss, gn, prefix in ((ref, "loss", "grad_norm", "p/"), (port, "loss0", "grad_norm0", "p0/")):
        if other is None:
            continue
        assert abs(float(port["loss"]) - float(other[loss])) <= 1e-5 * abs(float(other[loss]))
        assert abs(float(port["grad_norm"]) - float(other[gn])) <= 1e-4 * float(other[gn])
        keys = [k for k in port if k.startswith("p/")]
        assert keys and all(prefix + k[2:] in other for k in keys)
        for k in keys:
            w = port["w/" + k[2:]]
            close_to_scale(port[k] - w, other[prefix + k[2:]] - w, 1e-3)


@pytest.mark.parametrize("case", ["train_tp", "train_fsdp", "train_compress"])
def test_train_step_on_2x4_mesh(worlds, case):
    """The qwen smoke train step on 2 x 4 (``test_multidevice.py:106``)
    under "tp" and "fsdp", and with int8 gradient compression: loss, grad
    norm and every updated parameter against the reference's
    ``jit_train_step`` on its 2 x 4 mesh and against the port's step
    without a mesh."""
    _check_train(_load(worlds, 8, case, "port"), _load(worlds, 8, case, "ref"))


def test_train_step_mamba2_on_a_data_mesh(worlds):
    """mamba2 on (2, 1): the SSM family on a data-only mesh equals its
    step without a mesh."""
    _check_train(_load(worlds, 4, "train_mamba", "port"))


@pytest.mark.parametrize("case", ["train_encdec", "train_hybrid"])
def test_train_step_encdec_and_hybrid_on_a_mesh(worlds, case):
    """seamless on a data-only (2, 1) mesh and zamba2 under "fsdp" on
    (2, 2): each family's step equals its step without a mesh."""
    _check_train(_load(worlds, 4, case, "port"))


def test_train_on_a_mesh_resumes_from_a_checkpoint(worlds):
    """``train(mesh=)`` on (2, 2), 4 steps, a checkpoint every 2 and a
    failure before step 3: the restart restores onto the mesh and replays
    step 2; its losses and final parameters are bitwise the run without
    the failure, whose losses match ``train`` without a mesh."""
    res = _load(worlds, 4, "drill", "port")
    drill, whole, plain = res["drill"], res["whole"], res["plain"]
    assert int(res["restores"]) == 1 and len(drill) == 5 and len(whole) == len(plain) == 4
    assert drill[[0, 1, 2, 4]].tobytes() == whole.tobytes() and drill[3] == drill[2]
    np.testing.assert_allclose(whole, plain, rtol=1e-5)
    keys = [k for k in res if k.startswith("drill/")]
    assert keys
    for k in keys:
        assert res[k].tobytes() == res["whole/" + k[6:]].tobytes(), k


def test_train_step_with_collectives_staged_through_the_host(worlds):
    """The (1, 2) qwen step with every collective through
    ``HostStagedGloo`` (gloo ranks on a card) equals the step without a
    mesh."""
    _check_train(_load(worlds, "staged", "staged_train", "port"))


@pytest.mark.parametrize("case", ["serve_12", "serve_22"])
def test_batched_server_on_a_mesh(worlds, case):
    """``BatchedServer(mesh=)`` on (1, 2) and (2, 2): a 14-token prompt
    crosses the slab boundary at row 12 and one slot never fills; the
    tokens equal the reference server's on its mesh and the port's server
    without a mesh, and so does the cache."""
    port, ref = _load(worlds, 4, case, "port"), _load(worlds, 4, case, "ref")
    assert np.array_equal(port["mesh"], ref["tokens"])
    assert np.array_equal(port["mesh"], port["plain"])
    close_to_scale(port["k"], port["k_plain"], 1e-5)


def test_checkpoint_restores_onto_any_mesh(worlds):
    """Saved on (2, 2) in the logical layout; restored onto (1, 2) (at its
    placements) and without a mesh, every leaf bitwise the saved one; the
    reference's ``restore(shardings=)`` reads the same files bitwise."""
    from repro.checkpoint.ckpt import CheckpointManager as JManager
    from repro.parallel import steps as jsteps
    from repro.optim import adamw as jadamw

    res = _load(worlds, 4, "ckpt", "port")
    saved = {k[6:]: v for k, v in res.items() if k.startswith("saved/")}
    assert saved
    for prefix in ("r12/", "r0/"):
        for k, v in saved.items():
            got = res[prefix + k]
            assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), prefix + k
    assert str(res["placements_wq"]) == "(Replicate(), Shard(dim=2))"
    cj = dataclasses.replace(jreg.get(W.QWEN), param_dtype=jnp.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    from repro.configs.base import ShapeConfig

    _, bundle, abstract = jsteps.jit_train_step(cj, mesh, ShapeConfig(*W.TRAIN_SHAPE), opt_cfg=jadamw.AdamWConfig(**W.OPT))
    mgr = JManager(str(worlds[4][0] / "ckpt"))
    blob = mgr.restore(0, {"params": abstract[0], "opt": abstract[1]},
                       {"params": bundle["param_sh"], "opt": bundle["opt_sh"]})
    flat = W.flat(jax.tree_util.tree_map(np.asarray, blob))
    for k, v in saved.items():
        assert flat[k].tobytes() == v.tobytes(), k


# The collectives of one dense qwen layer on (1, 2) under "tp", each
# placement change written out in ``layers.py``:
# forward: ln1 runs on the sequence slab (none); attention gathers the
#   slab (all_gather 1) and reduce-scatters wo's partial output (1); ln2
#   none; the MLP gathers (all_gather 2) and reduce-scatters w_down's
#   output (2).
# backward: each gather's gradient is a reduce-scatter and each
#   reduce-scatter's an all-gather (2 + 2); the norm weights' gradients
#   (partial over the sequence slabs) and the other replicated weights'
#   stay partial (their reduction is the optimizer's ZeRO-2 redistribute,
#   outside the layer).
# decode step (1 layer): the embedding's partial rows are all-reduced
#   (1); q, K and V are gathered over the heads (3 all_gather; qwen's
#   biases are added on the heads' shards before); the slabs' outputs and
#   log-sum-exps are gathered (2); wo's partial output
#   (1) and the MLP's (1) are all-reduced; the unembedding's input needs
#   nothing and the argmax gathers the ranks' (max, index) (2 all_gather;
#   "data" is a size-1 axis and moves nothing).
COMM = {
    "fwd": {"all_gather_into_tensor": 2, "reduce_scatter_tensor": 2},
    "bwd": {"all_gather_into_tensor": 2, "reduce_scatter_tensor": 2},
    "decode": {"all_gather_into_tensor": 7, "all_reduce": 3},
}


def test_collective_counts(worlds):
    """No layer moves data it does not have to: the counts above."""
    res = _load(worlds, 4, "comm", "port")
    for what, want in COMM.items():
        got = {k: int(n) for k, n in res[what]}
        assert got == want, (what, got)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


def _padded_pair():
    base = dataclasses.replace(jreg.get("yi-34b", smoke=True), n_heads=6, n_kv=2, d_head=16)
    return base, dataclasses.replace(base, tp_pad=4)


def test_head_padding_exactness():
    """``test_model_parts.py::test_head_padding_exactness`` (:85), in the
    port and against the reference: padded execution equals unpadded, in
    training and in a decode step, with ``(Hp, gp, g) == (8, 4, 3)``."""
    jbase, jpad = _padded_pair()
    pbase = dataclasses.replace(preg.get("yi-34b", smoke=True), n_heads=6, n_kv=2, d_head=16)
    ppad = dataclasses.replace(pbase, tp_pad=4)
    Hp, gp, g = ppad.head_padding()
    assert (Hp, gp, g) == (8, 4, 3) == jpad.head_padding()
    d, Dh = pbase.d_model, pbase.d_head
    rng = np.random.default_rng(2)
    wb = W.weights(pL.attention_specs(pbase), 2)
    wp = W.weights(pL.attention_specs(ppad), 3)
    wq = wp["wq"].reshape(d, 2, gp, Dh)
    wq[:, :, :g] = wb["wq"].reshape(d, 2, g, Dh)
    wo = wp["wo"].reshape(2, gp, Dh, d)
    wo[:, :g] = wb["wo"].reshape(2, g, Dh, d)
    wp.update(wq=wq.reshape(d, Hp, Dh), wo=wo.reshape(Hp, Dh, d), wk=wb["wk"], wv=wb["wv"])
    x = rng.normal(size=(2, 16, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    cast = lambda t, dt: {k: (torch.from_numpy(v) if dt is None else jnp.asarray(v).astype(dt)) for k, v in t.items()}  # noqa: E731
    dt = pbase.param_dtype
    jdt = jbase.param_dtype
    got = pL.attention_apply({k: v.to(dt) for k, v in cast(wp, None).items()}, torch.from_numpy(x).to(dt), torch.from_numpy(pos), cfg=ppad)
    want = pL.attention_apply({k: v.to(dt) for k, v in cast(wb, None).items()}, torch.from_numpy(x).to(dt), torch.from_numpy(pos), cfg=pbase)
    ref = jL.attention_apply(cast(wp, jdt), jnp.asarray(x).astype(jdt), jnp.asarray(pos), cfg=jpad, backend="xla")
    tol = 1e-4 if dt == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)
    # a decode step over a cache of 12 rows
    kv = rng.normal(size=(2, 12, 2, Dh)).astype(np.float32)
    step = np.array([3, 11], np.int32)
    outs = []
    for w, cfg in ((wp, ppad), (wb, pbase)):
        cache = {"k": torch.from_numpy(kv.copy()).to(dt), "v": torch.from_numpy(kv[::-1].copy()).to(dt)}
        y, _ = pL.attention_decode({k: v.to(dt) for k, v in cast(w, None).items()}, torch.from_numpy(x[:, 0]).to(dt), cache, torch.from_numpy(step), cfg=cfg)
        outs.append(y.float().numpy())
    jcache = {"k": jnp.asarray(kv).astype(jdt), "v": jnp.asarray(kv[::-1].copy()).astype(jdt)}
    jy, _ = jL.attention_decode(cast(wp, jdt), jnp.asarray(x[:, 0]).astype(jdt), jcache, jnp.asarray(step), cfg=jpad, backend="xla")
    np.testing.assert_allclose(outs[0], outs[1], rtol=tol, atol=tol)
    np.testing.assert_allclose(outs[0], np.asarray(jy, np.float32), rtol=tol, atol=tol)


def test_moe_shard_map_path_matches_local():
    """``test_model_parts.py::test_moe_shard_map_path_matches_local``
    (:44): the expert-parallel path on a one-rank ("data", "model") gloo
    mesh equals the port's local path and the reference's 1 x 1 mesh
    path."""
    from repro.models.params import default_rules as jrules

    cj = dataclasses.replace(jreg.get("granite-moe-1b-a400m", smoke=True), param_dtype=jnp.float32)
    cp = dataclasses.replace(preg.get("granite-moe-1b-a400m", smoke=True), param_dtype=torch.float32)
    w = W.weights(pL.moe_specs(cp), 1)
    x = np.random.default_rng(1).normal(size=(2, 8, cp.d_model)).astype(np.float32)
    pp = pparams.tree_map(torch.from_numpy, w)
    local = pL.moe_apply(pp, torch.from_numpy(x), cfg=cp)
    mesh_j = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    want = jL.moe_apply(jax.tree_util.tree_map(jnp.asarray, w), jnp.asarray(x), cfg=cj, rules=jrules(mesh_j))
    with one_rank_mesh(("data", "model")) as mesh:
        rules = pparams.default_rules(mesh)
        specs = pL.moe_specs(cp)
        pd = pparams.tree_map(lambda t, s: pparams.shard_full(t, mesh, rules.placements(s)), pp, specs)
        xd = pparams.shard_full(torch.from_numpy(x), mesh, rules.placements_for(x.shape, ("batch", None, "embed")))
        got = pL.moe_apply(pd, xd, cfg=cp, rules=rules).full_tensor()
    assert torch.equal(got, local)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_slabs", [2, 3, 4])
def test_split_decode_matches_the_whole_cache(n_slabs, dtype):
    """The plain ``flash_decode`` with its log-sum-exp over the slabs of a
    sequence-sharded cache, combined (``layers.combine_slabs``), equals the
    call over the whole cache: rows whose visible keys end in the first
    slab (the others empty), a row with ``kv_len = 0`` (zeros), and rows
    with ``kv_len > S``."""
    rng = np.random.default_rng(n_slabs)
    B, S, H, Hkv, D = 5, 24, 8, 2, 16
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(np.float32)).to(dtype)
    kv_len = torch.tensor([3, 0, S, S + 7, 13], dtype=torch.int32)
    whole, lse = pref.decode_attention(q, k, v, kv_len, return_lse=True)
    assert torch.isinf(lse[1]).all() and torch.isfinite(lse[0]).all()
    Sl = S // n_slabs
    outs, lses = [], []
    for r in range(n_slabs):
        n = (kv_len - r * Sl).clamp(0, Sl).to(torch.int32)
        o, l = pref.decode_attention(q, k[:, r * Sl : (r + 1) * Sl], v[:, r * Sl : (r + 1) * Sl], n, return_lse=True)
        outs.append(o)
        lses.append(l)
    got = pL.combine_slabs(torch.stack(outs), torch.stack(lses))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), whole.float(), rtol=tol, atol=tol)
    # the whole-cache lse: log of the slabs' summed exponentials
    m = torch.stack(lses).amax(0)
    fin = torch.isfinite(m)
    total = m[fin] + torch.log(torch.exp(torch.stack(lses)[:, fin] - m[fin]).sum(0))
    torch.testing.assert_close(total, lse[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", [W.MAMBA, W.ZAMBA, W.SEAMLESS])
def test_one_by_one_mesh_is_bitwise_the_one_device_path(arch):
    """On a one-rank (1, 1) mesh under "tp" the SSM, hybrid and
    encoder-decoder families take their tensor-parallel paths (the Mamba2
    block on all its heads, the shared block's and the encoder-decoder's
    sharded attention, the cross decode over one slab), and a decode step
    (logits and every cache leaf) and the loss of a train step are bitwise
    the one-device path's.  Its gradients agree to within 1e-5 of each
    leaf's largest: on the CPU the norms' plain versions are autograd
    graphs, so a residual's gradient takes its contributions in another
    association where a layer's local function is one node on a mesh (the
    dense family's too); on the card each norm is one kernel a direction,
    and the chip phase holds the step bitwise."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import specs as S
    from repro_torch.launch.train import place_batch
    from repro_torch.models import carry
    from repro_torch.parallel import steps

    cfg = W._pcfg(arch)
    dec = pencdec.decode_step if cfg.family == "encdec" else plm.decode_step
    with one_rank_mesh(("data", "model")) as mesh:
        _, bundle = steps.make_serve_step(cfg, mesh=mesh)
        w = W._tensors(W.weights(bundle["specs"], 3))
        tree = S.cache_spec_tree(cfg, ShapeConfig("d", W.DECODE["ctx"], W.DECODE["batch"], "decode"))
        cache_np = W.weights(tree, 9)
        rules = bundle["rules"]
        cache = {k: pparams.shard_full(torch.from_numpy(v.copy()), mesh, rules.placements(tree[k])) for k, v in cache_np.items()}
        tok, pos = (torch.tensor(W.DECODE[k], dtype=torch.int32) for k in ("tokens", "pos"))
        bpl = rules.placements_for((4,), ("batch",))
        logits, cache = dec(cfg, carry.shard_params(w, bundle), cache, pparams.shard_full(tok, mesh, bpl),
                            pparams.shard_full(pos, mesh, bpl), rules=rules)
        plain, cache0 = dec(cfg, w, W._tensors(cache_np), tok, pos)
        assert torch.equal(logits.full_tensor(), plain)
        for k in cache0:
            assert torch.equal(cache[k].full_tensor(), cache0[k]), k
        sh = ShapeConfig(*W.TRAIN_SHAPE)
        _, tb, _ = steps.jit_train_step(cfg, mesh, sh)
        b = TokenSource(cfg, sh, DataConfig()).batch_at(0)
        loss, grads = steps.loss_and_grads(cfg, carry.shard_params(w, tb), place_batch(b, tb["batch_sh"], "cpu"), tb["rules"])
        loss0, grads0 = steps.loss_and_grads(cfg, w, place_batch(b, None, "cpu"))
        assert torch.equal(loss, loss0)
        got, want = W.flat(carry.gather_params(grads)), W.flat(grads0)
        assert got.keys() == want.keys()
        for k in want:
            close_to_scale(got[k], want[k], 1e-5)


@pytest.mark.parametrize("arch", [W.MAMBA, W.SEAMLESS])
def test_serve_requests_on_a_mesh(arch):
    """``serve_requests(mesh=)`` on a one-rank (1, 1) mesh under "tp"
    completes the same requests with the same token counts and steps as
    ``serve_requests`` without a mesh."""
    kw = dict(batch=2, ctx=16, n_requests=3, max_tokens=3, seed=1)
    plain = pserve.serve_requests(arch, device="cpu", **kw)
    with one_rank_mesh(("data", "model")) as mesh:
        got = pserve.serve_requests(arch, mesh=mesh, **kw)
    for k in ("completed", "tokens", "steps"):
        assert got[k] == plain[k], k


@pytest.mark.parametrize("arch", [W.MAMBA, W.ZAMBA, W.SEAMLESS])
def test_train_on_a_mesh(arch):
    """``train(mesh=)`` under "tp" on a one-rank (1, 1) mesh: two steps'
    losses within 1e-5 of ``train`` without a mesh (the first bitwise)."""
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw

    kw = dict(steps=2, batch=2, seq=64, seed=0, log_every=100, opt_cfg=adamw.AdamWConfig(**W.OPT))
    plain = train(W._pcfg(arch), device="cpu", **kw)["losses"]
    with one_rank_mesh(("data", "model")) as mesh:
        got = train(W._pcfg(arch), mesh=mesh, **kw)["losses"]
    assert got[0] == plain[0]
    np.testing.assert_allclose(got, plain, rtol=1e-5)


@pytest.mark.parametrize("case", [c for c, *_ in W.DECODE_CASES])
def test_tp_decode_step_of_ssm_hybrid_and_encdec(worlds, case):
    """One f32 decode step under "tp" over a random cache: mamba2 on
    (1, 2), (1, 4) and a "model" axis of 3 on which ``w_in`` and ``conv``
    replicate while the heads, ``norm`` and ``w_out`` shard (the
    reference's divisible-or-replicate rule, leaf by leaf); zamba2 on
    (1, 2) (its KV ring on sequence slabs); seamless on (1, 2) and (2, 2)
    (the self cache and the 3,072-row cross memory on slabs).  The logits,
    the SSM state ``h``, the conv tail and the K/V leaves equal the
    reference's ``decode_step`` on its mesh (jitted with the same
    shardings) within 1e-4 of each leaf's largest value, and the port's
    step without a mesh within 1e-5."""
    port, ref = _load(worlds, 8, case, "port"), _load(worlds, 8, case, "ref")
    close_to_scale(port["logits"], ref["logits"], 1e-4)
    close_to_scale(port["logits"], port["logits0"], 1e-5)
    leaves = [k[2:] for k in ref if k.startswith("c/")]
    assert leaves and sorted(leaves) == sorted(k[2:] for k in port if k.startswith("c/"))
    for k in leaves:
        close_to_scale(port["c/" + k], ref["c/" + k], 1e-4)
        close_to_scale(port["c/" + k], port["c0/" + k], 1e-5)


@pytest.mark.parametrize("case", [c for c, *_ in W.TP_TRAIN_CASES])
def test_tp_train_step_of_ssm_hybrid_and_encdec(worlds, case):
    """The train step under "tp" with ZeRO-1/2 for mamba2, zamba2 and
    seamless on (2, 2), and for the mixed mamba2 on (1, 3): loss, grad
    norm and every updated parameter against the reference's
    ``jit_train_step`` on its mesh and against the port's step without a
    mesh.  Every parameter and moment comes back at its logical
    placement (checked on the ranks); on (2, 2) some moments shard over
    "data" (ZeRO-1)."""
    port = _load(worlds, 4, case, "port")
    _check_train(port, _load(worlds, 4, case, "ref"))
    if case != "ttp_mamba_13":
        assert int(port["zero1_data_shards"]) > 0


@pytest.mark.parametrize("case", [c for c, *_ in W.TP_SERVE_CASES])
def test_tp_server_of_ssm_and_encdec(worlds, case):
    """``BatchedServer(mesh=)`` under "tp" on (1, 2) for mamba2 (the state
    on its heads, the conv tail on its channels) and seamless (the cross
    memory of ENC_LEN_DECODE rows on slabs, zero as in the reference,
    ROADMAP C.3): the tokens equal the reference server's on its mesh and
    the port's server without a mesh, through a reused slot, and so does
    the SSM state or the K cache."""
    port, ref = _load(worlds, 4, case, "port"), _load(worlds, 4, case, "ref")
    assert np.array_equal(port["mesh"], ref["tokens"])
    assert np.array_equal(port["mesh"], port["plain"])
    close_to_scale(port["k"], port["k_plain"], 1e-5)


def test_moe_with_experts_replicated_over_the_model_axis(worlds):
    """deepseek's 4 experts on a "model" axis of 3: the rules replicate
    them (its shared experts shard), every model rank runs all of them on
    its slab, and the output
    and every gradient (the residual's loss is not summed over model
    ranks) equal the local path's within the MoE's 2e-4.  The reference
    asserts there (``experts must divide the model axis``); the dry run's
    smoke cells on 16 x 16 need it."""
    res = _load(worlds, 4, "moe_replicated", "port")
    assert str(res["experts_placement"]) == "(Replicate(), Replicate())"
    np.testing.assert_allclose(res["y"], res["y0"], rtol=2e-4, atol=2e-4)
    keys = [k[2:] for k in res if k.startswith("g/")]
    assert len(keys) == len(pL.moe_specs(preg.get(W.MOE_SHARED)))
    for k in keys:
        close_to_scale(res["g/" + k], res["g0/" + k], 2e-4)


@pytest.mark.parametrize("case", ["ckpt_mamba", "ckpt_seamless"])
def test_ssm_and_encdec_checkpoints_restore_onto_any_mesh(worlds, case):
    """A mamba2 or seamless training state saved on (2, 2) under "tp"
    restores onto (1, 2), at that mesh's placements (``w_in`` or ``wq``
    sharded over "model"), and onto one device, every leaf bitwise the
    saved one."""
    res = _load(worlds, 4, case, "port")
    saved = {k[6:]: v for k, v in res.items() if k.startswith("saved/")}
    assert saved
    for prefix in ("r12/", "r0/"):
        for k, v in saved.items():
            got = res[prefix + k]
            assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), prefix + k
    assert str(res["placements_wq"]) == "(Replicate(), Shard(dim=2))"
