"""The port's dense model stack and serving driver against the JAX package.

Configs: ``qwen2.5-14b-smoke`` (f32, vocab 512, GQA 4/2 heads with QKV
bias), a variant with ``n_kv = 1``, where one kv head serves every query
head, and for the server ``granite-20b-smoke`` (layer norms with biases,
MQA, the gelu MLP).  Weights come from the JAX
package's ``init_params``; the QKV biases, the norm weights and the norm
biases, which it initialises to zeros and ones, are overwritten with
random values so their paths are tested; then the same numpy tree is
carried into the port (``models.carry``).

- ``rope``, ``attention_decode``, ``mlp_apply`` and ``decode_step`` match
  the JAX functions on their plain path (``backend="xla"``) to rtol = atol
  = 1e-5 (the KV caches to 1e-5 of their largest entry); one
  ``decode_step`` matches ``lm.decode_step(..., backend="interpret")``,
  which runs the Pallas kernels, to 1e-4;
- the port's ``BatchedServer`` gives the JAX ``BatchedServer``'s greedy
  tokens token for token, and the same positions, through one sequence of
  prefills and decodes, including one that drives a slot past its
  context (the cache write clamps);
- ``serve_requests`` completes the same requests with the same token
  counts.

The JAX server is built on a mesh with Auto axes: the reference's default
mesh fails under the installed JAX (ROADMAP queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch.configs import registry as preg
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.core.types import CoxUnsupported
from repro_torch.launch import serve as pserve
from repro_torch.models import carry
from repro_torch.models import layers as pL
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams

ARCH = "qwen2.5-14b-smoke"
GRANITE = "granite-20b-smoke"  # norm="ln" (norm biases), MQA, the gelu MLP
TOL = dict(rtol=1e-5, atol=1e-5)


def configs(n_kv=None, arch=ARCH):
    """The JAX and port configs of arch, optionally with ``n_kv`` changed."""
    cj, cp = jreg.get(arch), preg.get(arch)
    if n_kv is not None:
        cj = dataclasses.replace(cj, n_kv=n_kv)
        cp = dataclasses.replace(cp, n_kv=n_kv)
    return cj, cp


def jax_weights(cfg_j, seed=0):
    """The JAX package's weights as numpy, with the leaves it initialises
    to zeros and ones randomised: the attention biases and the norm
    weights, and the norm biases where the model has them."""
    tree = jparams.init_params(jlm.lm_specs(cfg_j), jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(seed + 100)
    attn = tree["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.3 * rng.normal(size=attn[name].shape)).astype(np.float32)
    for parent, name in ((tree["layers"], "ln1"), (tree["layers"], "ln2"), (tree, "final_norm")):
        shape = parent[name].shape
        parent[name] = (1 + 0.3 * rng.normal(size=shape)).astype(np.float32)
        if name + "_b" in parent:
            parent[name + "_b"] = (0.3 * rng.normal(size=shape)).astype(np.float32)
    return tree


def as_jax(tree):
    """The numpy tree as JAX arrays."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def close_to_scale(got: torch.Tensor, want, rtol=1e-5):
    """Within rtol of the tensor's largest magnitude, entry by entry.  For
    the KV caches: the reference's init draws wk/wv with fan_in = the head
    count, so K/V entries reach ~20 and f32 rounding after a few steps is
    ~1e-6 of that, above a fixed atol of 1e-5 on the small entries."""
    want = np.asarray(want)
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 1, 4, 16), (7, 2, 32), (2, 5, 3, 64)])
def test_rope_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    # positions up to a serving context: at angles of thousands of radians
    # the two frameworks' f32 exp (for the frequencies) part by an ulp,
    # which the angle multiplies past 1e-5
    positions = rng.integers(0, 512, size=shape[:-2]).astype(np.int32)
    want = jL.rope(jnp.asarray(x), jnp.asarray(positions))
    got = pL.rope(torch.from_numpy(x), torch.from_numpy(positions))
    close(got, want)


def test_rope_keeps_bf16_and_computes_angles_in_f32():
    x = np.random.default_rng(0).normal(size=(2, 1, 4, 16)).astype(np.float32)
    positions = np.array([[5], [4000]], np.int32)
    want = jL.rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(positions))
    got = pL.rope(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(positions))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=1e-6
    )


@pytest.mark.parametrize("n_kv", [None, 1])
def test_attention_decode_matches_jax(n_kv):
    cj, cp = configs(n_kv)
    tree = jax_weights(cj, seed=1)
    lj = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree["layers"]["attn"])
    lp = pparams.tree_map(lambda a: torch.from_numpy(np.array(a[0])), tree["layers"]["attn"])
    rng = np.random.default_rng(2)
    B, S = 3, 16
    x = rng.normal(size=(B, cj.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, B, S, cj.n_kv, cj.d_head)).astype(np.float32)
    pos = np.array([0, 9, 15], np.int32)
    yj, cache_j = jL.attention_decode(
        lj, jnp.asarray(x), {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])},
        jnp.asarray(pos), cfg=cj, backend="xla",
    )
    cache_p = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy())}
    yp, cache_p = pL.attention_decode(
        lp, torch.from_numpy(x), cache_p, torch.from_numpy(pos)
    )
    close(yp, yj)
    close_to_scale(cache_p["k"], cache_j["k"])
    close_to_scale(cache_p["v"], cache_j["v"])


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply_matches_jax(act):
    cj, cp = configs()
    cj, cp = dataclasses.replace(cj, act=act), dataclasses.replace(cp, act=act)
    spec_j = jL.mlp_specs(cj)
    p = jax.tree_util.tree_map(np.asarray, jparams.init_params(spec_j, jax.random.PRNGKey(3)))
    assert set(p) == set(pL.mlp_specs(cp))
    x = np.random.default_rng(4).normal(size=(5, cj.d_model)).astype(np.float32)
    want = jL.mlp_apply({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), cfg=cj)
    got = pL.mlp_apply({k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x), cfg=cp)
    close(got, want)


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------


def _caches(cj, cp, B, S, seed):
    kv = np.random.default_rng(seed).normal(size=(2, cj.n_layers, B, S, cj.n_kv, cj.d_head))
    kv = kv.astype(np.float32)
    tree = {"k": kv[0], "v": kv[1]}
    return {k: jnp.asarray(a) for k, a in tree.items()}, carry.cache_from_numpy(cp, tree, "cpu")


@pytest.mark.parametrize("n_kv", [None, 1])
def test_decode_step_matches_jax(n_kv):
    """Several steps on a stale cache, one slot at and past the cache's
    end (the write clamps to S-1; kv_len > S attends to all of it)."""
    cj, cp = configs(n_kv)
    tree = jax_weights(cj, seed=5)
    pj, pp = as_jax(tree), carry.from_jax_params(cp, tree, "cpu")
    B, S = 3, 16
    cache_j, cache_p = _caches(cj, cp, B, S, seed=6)
    rng = np.random.default_rng(7)
    for step in range(4):
        toks = rng.integers(0, cj.vocab, size=B).astype(np.int32)
        pos = np.array([step, 7 + step, 15 + step], np.int32)
        lj, cache_j = jlm.decode_step(
            cj, pj, cache_j, jnp.asarray(toks), jnp.asarray(pos), backend="xla"
        )
        lp, cache_p = plm.decode_step(
            cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos)
        )
        assert lp.dtype == torch.float32 and lp.shape == lj.shape
        close(lp, lj)
        close_to_scale(cache_p["k"], cache_j["k"])
        close_to_scale(cache_p["v"], cache_j["v"])
        assert torch.equal(lp.argmax(-1), torch.from_numpy(np.asarray(jnp.argmax(lj, -1))))


def test_decode_step_matches_the_pallas_kernels():
    """The reference's decode step through its Pallas kernels (interpret
    mode) against the port's, which runs the kernels' plain versions on
    the CPU: rtol = atol = 1e-4."""
    cj, cp = configs()
    tree = jax_weights(cj, seed=8)
    B, S = 2, 128  # S a multiple of the Pallas decode block
    cache_j, cache_p = _caches(cj, cp, B, S, seed=9)
    toks = np.array([3, 411], np.int32)
    pos = np.array([40, 127], np.int32)
    lj, cj_out = jlm.decode_step(
        cj, as_jax(tree), cache_j, jnp.asarray(toks), jnp.asarray(pos), backend="interpret"
    )
    pp = carry.from_jax_params(cp, tree, "cpu")
    lp, cp_out = plm.decode_step(cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos))
    close(lp, lj, rtol=1e-4, atol=1e-4)
    close_to_scale(cp_out["k"], cj_out["k"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _servers(batch, ctx, seed=10, arch=ARCH):
    cj, cp = configs(arch=arch)
    tree = jax_weights(cj, seed=seed)
    js = jserve.BatchedServer(arch, batch=batch, ctx=ctx, params=as_jax(tree), mesh=auto_mesh())
    ps = pserve.BatchedServer(
        arch, batch=batch, ctx=ctx, params=carry.from_jax_params(cp, tree, "cpu"), device="cpu"
    )
    return js, ps


def _same_state(js, ps):
    assert np.array_equal(ps.pos, js.pos), (ps.pos, js.pos)
    assert np.array_equal(ps.active, js.active)
    assert np.array_equal(ps.tokens, js.tokens)
    assert ps.outputs == js.outputs


@pytest.mark.parametrize("arch", [ARCH, GRANITE])
def test_batched_server_matches_the_jax_server(arch):
    """Prefills, decodes, and a slot retired and refilled mid-flight: the
    same tokens, positions and K/V caches (1e-5 of their scale)."""
    js, ps = _servers(batch=2, ctx=32, arch=arch)
    cj, _ = configs(arch=arch)
    assert ps.cache["k"].shape == (cj.n_layers, 2, 32, cj.n_kv, cj.d_head)
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(1, 512, size=n)) for n in (3, 4, 5)]
    for server in (js, ps):
        server.prefill_prompt(0, prompts[0])
        server.prefill_prompt(1, prompts[1])
    _same_state(js, ps)
    assert ps.pos.tolist() == [7, 4]  # slot 0 advanced during slot 1's prefill
    for server in (js, ps):
        server.decode(5)
    _same_state(js, ps)
    for server in (js, ps):
        server.active[0] = False  # retire slot 0, refill it mid-flight
        server.prefill_prompt(0, prompts[2])
        server.decode(6)
    _same_state(js, ps)
    assert ps.steps == 3 + 4 + 5 + 5 + 6
    close_to_scale(ps.cache["k"], js.cache["k"])
    close_to_scale(ps.cache["v"], js.cache["v"])


def test_batched_server_clamps_a_slot_pushed_past_its_context():
    """Slot 0's position runs past ``ctx`` while slot 1 prefills; its
    cache write clamps to the last row, as ``dynamic_update_slice`` does,
    and both servers agree on every token and position."""
    js, ps = _servers(batch=2, ctx=12, seed=12)
    rng = np.random.default_rng(13)
    prompts = [list(rng.integers(1, 512, size=8)) for _ in range(2)]
    for server in (js, ps):
        server.prefill_prompt(0, prompts[0])
        server.prefill_prompt(1, prompts[1])
    assert ps.pos.tolist() == [16, 8] and ps.ctx == 12
    for server in (js, ps):
        server.decode(6)
    _same_state(js, ps)
    assert not ps.active.any()


@pytest.mark.parametrize("arch", [ARCH, GRANITE])
def test_serve_requests_matches_the_jax_counts(monkeypatch, arch):
    monkeypatch.setattr(jserve, "make_host_mesh", lambda **kw: auto_mesh())
    kw = dict(batch=2, ctx=24, n_requests=3, max_tokens=4, seed=0)
    want = jserve.serve_requests(arch, **kw)
    got = pserve.serve_requests(arch, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])
    assert got["completed"] == 3 and got["steps"] >= len(got["step_s"]) > 0


# ---------------------------------------------------------------------------
# layouts, counts, and what is not ported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jreg.ARCHS))
def test_configs_match_the_reference(name):
    for smoke in (False, True):
        cj, cp = jreg.get(name, smoke), preg.get(name, smoke)
        fields = {f.name for f in dataclasses.fields(cj)} - {"param_dtype"}
        # the port's own fields (the hybrid_moe family's) stay at their
        # defaults in the reference's configurations
        assert {f.name for f in dataclasses.fields(cp)} - {"param_dtype"} == fields | PORT_FIELDS
        assert not fields & PORT_FIELDS
        for f in fields:
            assert getattr(cp, f) == getattr(cj, f), (name, smoke, f)
        defaults = {f.name: f.default for f in dataclasses.fields(cp) if f.name in PORT_FIELDS}
        assert {f: getattr(cp, f) for f in PORT_FIELDS} == defaults, (name, smoke)
        assert str(cp.param_dtype) == f"torch.{jnp.dtype(cj.param_dtype)}"
        assert cp.param_count() == cj.param_count()
        assert cp.head_padding() == cj.head_padding()


def test_spec_trees_match_the_reference():
    cj, cp = configs()
    sj = jax.tree_util.tree_leaves_with_path(jlm.lm_specs(cj), is_leaf=jparams.is_spec)
    flat = {jax.tree_util.keystr(path): s for path, s in sj}
    sp = plm.lm_specs(cp)

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v

    port = dict(walk(sp))
    assert set(port) == set(flat)
    for key, s in port.items():
        assert s.shape == flat[key].shape and s.init == flat[key].init, key
        assert str(s.dtype) == f"torch.{jnp.dtype(flat[key].dtype)}", key


def test_init_params_follows_the_std_rule():
    spec = {"w": pparams.ParamSpec((3, 400, 50), torch.float32, scale=2.0),
            "b": pparams.ParamSpec((7,), torch.float32, init="ones")}
    gen = torch.Generator().manual_seed(0)
    p = pparams.init_params(spec, gen, "cpu")
    assert float(p["w"].std()) == pytest.approx(2.0 / 400**0.5, rel=0.02)
    assert torch.equal(p["b"], torch.ones(7))
    again = pparams.init_params(spec, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["w"], p["w"])


def test_carry_refuses_a_tree_of_another_layout():
    cj, cp = configs()
    tree = jax_weights(cj)
    del tree["layers"]["attn"]["bq"]
    with pytest.raises(ValueError, match="keys"):
        carry.from_jax_params(cp, tree, "cpu")
    tree = jax_weights(cj)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="shape"):
        carry.from_jax_params(cp, tree, "cpu")


def test_carry_takes_bf16_leaves():
    cfg = dataclasses.replace(configs()[0], param_dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(
        np.asarray, jparams.init_params(jlm.lm_specs(cfg), jax.random.PRNGKey(0))
    )
    port_cfg = dataclasses.replace(configs()[1], param_dtype=torch.bfloat16)
    p = carry.from_jax_params(port_cfg, tree, "cpu")
    assert p["embed"]["tok"].dtype == torch.bfloat16
    want = np.asarray(tree["embed"]["tok"], np.float32)
    assert np.array_equal(p["embed"]["tok"].float().numpy(), want)


@pytest.mark.parametrize("arch", ["llava-next-34b-smoke", "zamba2-1.2b-smoke",
                                  "deepseek-moe-16b-smoke", "seamless-m4t-large-v2-smoke"])
def test_unported_families_and_norms_raise(arch):
    """The VLM, hybrid, MoE and encoder-decoder families (ported: ROADMAP
    A.7.1-A.7.4) build a server whose cache has the reference server's
    keys, shapes and dtypes (the encoder-decoder cache with its cross K/V
    of ENC_LEN_DECODE rows)."""
    server = pserve.BatchedServer(arch, batch=2, ctx=8, device="cpu")
    want = jspecs.cache_spec_tree(jreg.get(arch), JShape("serve_8", 8, 2, "decode"))
    assert set(server.cache) == set(want)
    for leaf, t in server.cache.items():
        assert tuple(t.shape) == want[leaf].shape, leaf
        assert str(t.dtype) == f"torch.{jnp.dtype(want[leaf].dtype)}", leaf


@pytest.mark.parametrize("knob", ["postproc", "graph", "chaos", "autotune"])
def test_unported_serving_knobs_raise(knob, capsys, tmp_path, monkeypatch):
    """The runtime services lift every serving refusal: the
    ``postproc``, ``graph`` and ``chaos`` knobs (ROADMAP A.9.2) and
    ``--autotune`` (A.9.3) run through ``serve_requests`` and the CLI on
    the CPU; ``--autotune`` tunes the postprocess launches and prints the
    tuner's cell."""
    from repro_torch.core import autotune

    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    argv = ["--arch", ARCH, "--batch", "1", "--ctx", "8", "--requests", "1", "--tokens", "1"]
    if knob == "autotune":
        monkeypatch.setenv(autotune.ENV_ENABLE, "1")  # restored after the test
        autotune.reset()
        cli = pserve.main(argv + ["--device", "cpu", "--postproc", "--autotune"])
        assert cli["completed"] == 1 and cli["postproc"]["failed"] == 0
        assert cli["dispatch_health"]["autotune"]["misses"] == 1
        assert "[autotune: 0h/0dh/1m," in capsys.readouterr().out
        autotune.reset()
        return
    knobs = {"postproc": True, knob: True}
    out = pserve.serve_requests(ARCH, batch=1, ctx=8, n_requests=1, max_tokens=1, device="cpu", **knobs)
    assert out["completed"] == 1 and "postproc" in out
    flags = ["--postproc"] + ([f"--{knob}"] if knob != "postproc" else [])
    cli = pserve.main(argv + ["--device", "cpu"] + flags)
    assert cli["completed"] == 1
    printed = capsys.readouterr().out
    assert "postproc kernels" in printed and "dispatch health" in printed
    if knob == "graph":
        assert out["graph"]["replayed"] and "graph replay" in printed
    if knob == "chaos":
        assert out["postproc"]["failed"] == 1 and "1 faulted" in printed


@pytest.mark.parametrize("pin", [False, True], ids=["auto", "chaos"])
def test_request_kernel_pool_knobs(pin):
    """The postprocess pool leaves its launches on the auto knobs, as the
    reference's does (so ``--autotune`` tunes them), and pins the serial
    scan only for the fault drill, whose one fault the vmap -> scan
    ladder would otherwise absorb; the histograms are the same."""
    pool = pserve.RequestKernelPool(2, nbins=8, device="cpu", pin_scan=pin)
    toks = [list(range(1, 400)), [4, 4, 4]]
    for slot, t in enumerate(toks):
        pool.submit(slot, t)
    hists = pool.collect()
    for h, t in zip(hists, toks):
        np.testing.assert_array_equal(h, np.bincount(np.array(t) % 8, minlength=8))
    reqs = [h.request for h in pool.handles]
    want = ("scan", "serial") if pin else ("auto", "auto")
    assert all((r.req_backend, r.req_warp_exec) == want for r in reqs)
    if not pin:  # 399 tokens fill 7 blocks: auto picks the block-parallel backend
        assert reqs[0].rl.backend == "vmap"


def _carried_serve_requests(monkeypatch, arch=ARCH, seed=10):
    """Both packages' ``serve_requests`` build their servers on the same
    carried weights (the reference's on the Auto-axes mesh)."""
    cj, cp = configs(arch=arch)
    tree = jax_weights(cj, seed=seed)
    jcls, pcls = jserve.BatchedServer, pserve.BatchedServer
    monkeypatch.setattr(
        jserve, "BatchedServer", lambda a, **kw: jcls(a, params=as_jax(tree), mesh=auto_mesh(), **kw)
    )
    monkeypatch.setattr(
        pserve,
        "BatchedServer",
        lambda a, **kw: pcls(a, params=carry.from_jax_params(cp, tree, "cpu"), **kw),
    )


SERVE_KW = dict(batch=2, ctx=24, n_requests=3, max_tokens=4, seed=0)


def test_serve_requests_postproc_graph_matches_the_jax_server(monkeypatch):
    """The per-slot postprocess kernels and the captured token pipeline:
    the same tokens, histogram counts and graph statistics as the JAX
    server, and a clean dispatcher (no degradation, no sticky error)."""
    _carried_serve_requests(monkeypatch)
    kw = dict(SERVE_KW, postproc=True, graph=True)
    want = jserve.serve_requests(ARCH, **kw)
    got = pserve.serve_requests(ARCH, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])
    for k in ("requests", "hist_tokens", "failed"):
        assert got["postproc"][k] == want["postproc"][k], k
    for k in ("steps", "hist_tokens", "replayed"):
        assert got["graph"][k] == want["graph"][k], k
    assert got["graph"]["cuda_graph"] is False  # the host runs the nodes
    dh = got["dispatch_health"]
    assert dh["degradations"] == 0 and dh["sticky"] is None


def test_serve_requests_chaos_matches_the_jax_server(monkeypatch):
    """The fault drill: slot 0's first postprocess launch fails, its
    stream's later request fails as its dependency, the other slots
    complete; the same counts and error kinds as the JAX server."""
    _carried_serve_requests(monkeypatch)
    kw = dict(SERVE_KW, postproc=True, chaos=True)
    want = jserve.serve_requests(ARCH, **kw)
    got = pserve.serve_requests(ARCH, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])
    gh, wh = got["postproc"]["health"], want["postproc"]["health"]
    for k in ("submitted", "completed", "failed", "failed_slots"):
        assert gh[k] == wh[k], k
    assert [e.split("(")[0] for e in gh["errors"]] == [e.split("(")[0] for e in wh["errors"]]
    assert got["postproc"]["hist_tokens"] == want["postproc"]["hist_tokens"]
    with pytest.raises(ValueError, match="postproc"):
        pserve.serve_requests(ARCH, device="cpu", **dict(SERVE_KW, chaos=True))


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
def test_token_pipeline_matches_the_reference(graph):
    """The token pipeline's statistics after a run of steps with idle
    slots: bitwise the reference pipeline's, eager and replayed."""
    rng = np.random.default_rng(21)
    steps = [(rng.integers(0, 512, size=3).astype(np.int32), rng.random(3) < 0.7) for _ in range(6)]
    ref, port = jserve.TokenPipeline(3, graph=graph), pserve.TokenPipeline(3, graph=graph, device="cpu")
    for toks, active in steps:
        ref.step(toks, active)
        port.step(toks, active)
    want, got = ref.collect(), port.collect()
    assert set(got) == set(want) == {"hist", "tot", "sq"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert int(got["hist"].sum()) == sum(int(a.sum()) for _, a in steps)
    assert (port.graph_exec is not None) == graph


def test_q_head_padding_raises():
    """``tp_pad`` pads q heads inside each kv group (the refusal it
    replaces was lifted by ROADMAP A.10.2): a padded layer, whose padded
    heads are masked before ``wo``, equals the unpadded one in training
    and in decode when the true heads' weights are carried over."""
    base = dataclasses.replace(configs()[1], n_heads=6, n_kv=2, d_head=16, param_dtype=torch.float32)
    padded = dataclasses.replace(base, tp_pad=4)
    Hp, gp, g = padded.head_padding()
    assert (Hp, gp, g) == (8, 4, 3)
    rng = np.random.default_rng(31)
    d, Dh = base.d_model, base.d_head

    def draw(shape):
        return torch.from_numpy((rng.normal(size=shape) / np.sqrt(d)).astype(np.float32))

    pb = {n: draw(s.shape) for n, s in pL.attention_specs(base).items()}
    pp = {n: draw(s.shape) for n, s in pL.attention_specs(padded).items()}
    wq = pp["wq"].reshape(d, 2, gp, Dh).clone()
    wq[:, :, :g] = pb["wq"].reshape(d, 2, g, Dh)
    wo = pp["wo"].reshape(2, gp, Dh, d).clone()
    wo[:, :g] = pb["wo"].reshape(2, g, Dh, d)
    pp.update(wq=wq.reshape(d, Hp, Dh), wo=wo.reshape(Hp, Dh, d), wk=pb["wk"], wv=pb["wv"])
    if "bq" in pb:
        bq = pp["bq"].reshape(2, gp, Dh).clone()
        bq[:, :g] = pb["bq"].reshape(2, g, Dh)
        pp.update(bq=bq.reshape(Hp, Dh), bk=pb["bk"], bv=pb["bv"])
    x = torch.from_numpy(rng.normal(size=(2, 16, d)).astype(np.float32))
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    got = pL.attention_apply(pp, x, pos, cfg=padded)
    want = pL.attention_apply(pb, x, pos, cfg=base)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    cache = lambda: {k: torch.from_numpy(rng.normal(size=(2, 12, 2, Dh)).astype(np.float32)) for k in "kv"}  # noqa: E731
    cb = cache()
    cpad = {k: v.clone() for k, v in cb.items()}
    step = torch.tensor([3, 11], dtype=torch.int32)
    yb, _ = pL.attention_decode(pb, x[:, 0], cb, step, cfg=base)
    yp, _ = pL.attention_decode(pp, x[:, 0], cpad, step, cfg=padded)
    torch.testing.assert_close(yp, yb, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(cb[k], cpad[k]) for k in cb)
