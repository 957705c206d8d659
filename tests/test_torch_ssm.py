"""The port's SSM family (Mamba2) against the JAX package, on the CPU.

Config: ``mamba2-130m-smoke`` (f32, 2 layers, d_model 64, d_inner 128,
8 SSD heads of P = 16, N = 16, vocab 512).  Weights come from the JAX
package's ``init_params``; ``A_log``, ``dt_bias``, ``D`` and the norm
weights, which it initialises to constants, are overwritten with random
values (``A = -exp(A_log)`` stays negative) so that a wrong decay, step or
skip term shows; then the same numpy tree is carried into the port
(``models.carry``).  Inputs are drawn from seeded numpy generators.

- the port's plain ``ssd_scan`` (sequential) and ``ssd_scan_chunked``
  match the reference's and its Pallas kernel (``interpret=True``) on the
  sweeps of ``tests/test_kernels.py`` and a batched mamba2-130m-shaped
  case: 1e-3 against the sequential oracle (the reference's own), 1e-5
  between the chunked forms;
- autograd through the plain chunked form matches ``jax.grad`` through the
  reference's within 1e-4 of each gradient's largest magnitude;
- ``mamba2_apply``, ``mamba2_decode`` (with its ``h``/``conv`` state over
  several steps), ``decode_step``, ``forward`` and the gradients match the
  JAX functions within 1e-5 of the output's scale (1e-4 through the
  Pallas kernel, and for the gradients);
- the server gives the JAX server's tokens, token for token, through more
  requests than slots: a reused slot keeps the previous request's state,
  as the reference's does (ROADMAP C);
- three ``make_train_step`` steps match ``jit_train_step`` at the
  tolerances of ``tests/test_torch_train.py``;
- the train and serve CLIs run on the CPU, and the entry points default
  to CUDA and raise without it, for mamba2 and for granite-20b-smoke.

The JAX steps are built on a mesh with Auto axes: the reference's default
mesh fails under the installed JAX (ROADMAP queue C).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro.launch import serve as jserve
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.optim import adamw as jadamw
from repro.parallel import steps as jsteps
from repro_torch.configs import registry as preg
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.models import carry
from repro_torch.models import layers as pL
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams
from repro_torch.optim import adamw as padamw
from repro_torch.parallel import steps as psteps

ARCH = "mamba2-130m-smoke"
GRANITE = "granite-20b-smoke"  # a dense model, for the CLI and device tests


def configs(**changes):
    cj, cp = jreg.get(ARCH), preg.get(ARCH)
    if changes:
        cj = dataclasses.replace(cj, **changes)
        cp = dataclasses.replace(cp, **changes)
    return cj, cp


def jax_weights(cfg_j, seed=0, dt_shift=0.0):
    """The JAX package's weights as numpy, the constant inits randomised;
    ``dt_shift`` moves ``dt_bias`` (softplus's large-input side)."""
    tree = jparams.init_params(jlm.lm_specs(cfg_j), jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(seed + 100)

    def draw(shape, mean, scale):
        return (mean + scale * rng.normal(size=shape)).astype(np.float32)

    m = tree["layers"]["mamba"]
    m["A_log"] = draw(m["A_log"].shape, 0.0, 0.5)
    m["dt_bias"] = draw(m["dt_bias"].shape, dt_shift, 0.5)
    m["D"] = draw(m["D"].shape, 1.0, 0.3)
    m["norm"] = draw(m["norm"].shape, 1.0, 0.3)
    tree["layers"]["ln1"] = draw(tree["layers"]["ln1"].shape, 1.0, 0.3)
    tree["final_norm"] = draw(tree["final_norm"].shape, 1.0, 0.3)
    return tree


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(tree):
    return pparams.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def close_to_scale(got: torch.Tensor, want, rtol):
    """Within rtol of the tensor's largest magnitude, entry by entry."""
    want = np.asarray(want, np.float32)
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol, atol=atol)


def leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def get_path(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def ssd_inputs(rng, shape_x, N):
    """x, a, b, c as tests/test_kernels.py draws them (a <= -0.05)."""
    *lead, S, H, P = shape_x
    x = (0.5 * rng.normal(size=shape_x)).astype(np.float32)
    a = (-np.abs(0.3 * rng.normal(size=(*lead, S, H))) - 0.05).astype(np.float32)
    b = (0.3 * rng.normal(size=(*lead, S, N))).astype(np.float32)
    c = (0.3 * rng.normal(size=(*lead, S, N))).astype(np.float32)
    return x, a, b, c


def torch_args(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# the plain SSD scan against the reference and its Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [
        (0, 256, 2, 64, 32, 64),  # the reference sweeps (B 0: one sequence)
        (0, 128, 4, 32, 16, 128),
        (0, 512, 1, 128, 64, 128),
        (2, 256, 24, 64, 128, 128),  # mamba2-130m's heads, batched
    ],
)
def test_plain_ssd_scan_matches_jax_and_pallas(B, S, H, P, N, chunk):
    rng = np.random.default_rng(S + H + P + N)
    shape = (B, S, H, P) if B else (S, H, P)
    x, a, b, c = ssd_inputs(rng, shape, N)
    seq = ref.ssd_scan(*torch_args(x, a, b, c))
    chunked = ref.ssd_scan_chunked(*torch_args(x, a, b, c), chunk=chunk)
    assert seq.shape == chunked.shape == x.shape and chunked.dtype == torch.float32
    for i in range(B or 1):
        row = [jnp.asarray(t[i] if B else t) for t in (x, a, b, c)]
        want_seq = jref.ssd_scan(*row)
        want_chunked = jref.ssd_scan_chunked(*row, chunk=chunk)
        want_pallas = jssd.ssd_scan(*row, chunk=chunk, interpret=True)
        got_seq, got_chunked = (t[i] if B else t for t in (seq, chunked))
        for got in (got_seq, got_chunked):
            np.testing.assert_allclose(got.numpy(), np.asarray(want_seq), rtol=1e-3, atol=1e-3)
        for want in (want_chunked, want_pallas):
            np.testing.assert_allclose(got_chunked.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "shape,N,chunk", [((256, 2, 64), 32, 64), ((2, 128, 3, 16), 16, 64), ((2, 64, 8, 16), 16, 64)]
)
def test_plain_ssd_scan_gradient_matches_jax(shape, N, chunk):
    rng = np.random.default_rng(len(shape) + N)
    x, a, b, c = ssd_inputs(rng, shape, N)
    dy = rng.normal(size=shape).astype(np.float32)
    got = ref.ssd_scan_bwd(*torch_args(x, a, b, c, dy), chunk=chunk)
    fn = functools.partial(jref.ssd_scan_chunked, chunk=chunk)
    if len(shape) == 4:
        fn = jax.vmap(fn)
    _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (x, a, b, c)))
    want = vjp(jnp.asarray(dy))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close_to_scale(g, w, 1e-4)


def test_cpu_ssd_scan_is_the_plain_chunked_form_and_launches_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    x, a, b, c = ssd_inputs(rng, (2, 96, 3, 16), 16)
    dy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    leaves = [t.requires_grad_(True) for t in torch_args(x, a, b, c)]
    y = ops.ssd_scan(*leaves, chunk=32)
    assert torch.equal(y, ref.ssd_scan_chunked(*leaves, chunk=32))
    got = torch.autograd.grad(y, leaves, dy)
    for g, w in zip(got, ref.ssd_scan_bwd(*leaves, dy, chunk=32)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # chunk = min(chunk, S) must divide S, the reference's rule
    assert torch.equal(ops.ssd_scan(*leaves[:4], chunk=500), ref.ssd_scan_chunked(*leaves, 96))
    with pytest.raises(ValueError, match="divide"):
        ops.ssd_scan(*leaves, chunk=64)
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def layer0(tree):
    """Layer 0's Mamba2 weights, as JAX arrays and as tensors."""
    m = tree["layers"]["mamba"]
    return (
        jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), m),
        pparams.tree_map(lambda a: torch.from_numpy(np.array(a[0])), m),
    )


@pytest.mark.parametrize("backend,tol", [("xla", 1e-5), ("interpret", 1e-4)])
@pytest.mark.parametrize("dt_shift", [0.0, 25.0])
def test_mamba2_apply_matches_jax(backend, tol, dt_shift):
    """dt_shift 25 puts softplus past torch's threshold of 20, where
    ``F.softplus`` returns its input and JAX's ``logaddexp`` form does not."""
    cj, cp = configs()
    lj, lp = layer0(jax_weights(cj, seed=1, dt_shift=dt_shift))
    x = np.random.default_rng(2).normal(size=(2, 64, cj.d_model)).astype(np.float32)
    want = jL.mamba2_apply(lj, jnp.asarray(x), cfg=cj, backend=backend)
    got = pL.mamba2_apply(lp, torch.from_numpy(x), cfg=cp)
    assert got.shape == want.shape and got.dtype == torch.float32
    close_to_scale(got, want, tol)


def test_softplus_is_jaxs():
    x = np.array([-90.0, -20.0, -1.5, 0.0, 0.3, 19.0, 20.5, 25.0, 90.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    # atol: XLA flushes softplus(-90), a subnormal, to zero on the CPU
    np.testing.assert_allclose(
        pL._softplus(torch.from_numpy(x)).numpy(), want, rtol=1e-6, atol=1e-37
    )


def test_causal_conv_matches_jax():
    """The conv's K shifted products summed in order, with and without a
    streaming state, in f32 (in bf16 XLA fuses the sum and rounds once)."""
    rng = np.random.default_rng(4)
    xbc = rng.normal(size=(2, 5, 24)).astype(np.float32)
    conv = (0.5 * rng.normal(size=(4, 24))).astype(np.float32)
    state = rng.normal(size=(2, 3, 24)).astype(np.float32)
    for st in (None, state):
        want, want_state = jL._causal_conv(
            jnp.asarray(xbc), jnp.asarray(conv), None if st is None else jnp.asarray(st)
        )
        got, got_state = pL._causal_conv(
            torch.from_numpy(xbc), torch.from_numpy(conv),
            None if st is None else torch.from_numpy(st),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


def test_mamba2_decode_matches_jax_over_steps():
    """Five steps from a random state; the output and the returned h and
    conv state within 1e-5 of their scale at every step, each side fed its
    own state."""
    cj, cp = configs()
    lj, lp = layer0(jax_weights(cj, seed=5))
    rng = np.random.default_rng(6)
    B = 3
    h0 = rng.normal(size=(B, cj.ssm_heads, cj.ssm_state, cj.ssm_head_dim)).astype(np.float32)
    conv0 = rng.normal(size=(B, cj.conv_k - 1, cj.ssm_inner + 2 * cj.ssm_state))
    conv0 = conv0.astype(np.float32)
    sj = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0)}
    sp = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(conv0)}
    for _ in range(5):
        x = rng.normal(size=(B, cj.d_model)).astype(np.float32)
        yj, sj = jL.mamba2_decode(lj, jnp.asarray(x), sj, cfg=cj, backend="xla")
        yp, sp = pL.mamba2_decode(lp, torch.from_numpy(x), sp, cfg=cp)
        close_to_scale(yp, yj, 1e-5)
        close_to_scale(sp["h"], sj["h"], 1e-5)
        close_to_scale(sp["conv"], sj["conv"], 1e-5)


# ---------------------------------------------------------------------------
# the model: decode step, caches, forward, gradients, training
# ---------------------------------------------------------------------------


def jax_cache(cj, B, seed):
    """A random SSM cache in the JAX layout, as numpy."""
    rng = np.random.default_rng(seed)
    specs = jax.tree_util.tree_map(
        lambda s: s.shape, jlm.cache_specs(cj, B, 16), is_leaf=jparams.is_spec
    )
    return {k: rng.normal(size=shape).astype(np.float32) for k, shape in specs.items()}


def test_decode_step_matches_jax():
    cj, cp = configs()
    tree = jax_weights(cj, seed=7)
    pj, pp = as_jax(tree), carry.from_jax_params(cp, tree, "cpu")
    B = 3
    cache_np = jax_cache(cj, B, seed=8)
    cache_j = as_jax(cache_np)
    cache_p = carry.cache_from_numpy(cp, cache_np, "cpu")
    h_cache = cache_p["h"]
    rng = np.random.default_rng(9)
    for step in range(4):
        toks = rng.integers(0, cj.vocab, size=B).astype(np.int32)
        pos = np.array([step, 5 + step, 40 + step], np.int32)
        lj, cache_j = jlm.decode_step(
            cj, pj, cache_j, jnp.asarray(toks), jnp.asarray(pos), backend="xla"
        )
        lp, cache_p = plm.decode_step(cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos))
        assert lp.dtype == torch.float32 and lp.shape == lj.shape
        close_to_scale(lp, lj, 1e-5)
        close_to_scale(cache_p["h"], cache_j["h"], 1e-5)
        close_to_scale(cache_p["conv"], cache_j["conv"], 1e-5)
        assert torch.equal(lp.argmax(-1), torch.from_numpy(np.asarray(jnp.argmax(lj, -1))))
    assert cache_p["h"] is h_cache  # updated in place


def test_decode_step_matches_the_pallas_kernels():
    """The reference's decode step through its Pallas rmsnorm (interpret
    mode) against the port's plain path: 1e-4 of the logits' scale."""
    cj, cp = configs()
    tree = jax_weights(cj, seed=10)
    cache_np = jax_cache(cj, 2, seed=11)
    toks = np.array([3, 411], np.int32)
    pos = np.array([4, 9], np.int32)
    lj, _ = jlm.decode_step(
        cj, as_jax(tree), as_jax(cache_np), jnp.asarray(toks), jnp.asarray(pos),
        backend="interpret",
    )
    lp, _ = plm.decode_step(
        cp, carry.from_jax_params(cp, tree, "cpu"), carry.cache_from_numpy(cp, cache_np, "cpu"),
        torch.from_numpy(toks), torch.from_numpy(pos),
    )
    close_to_scale(lp, lj, 1e-4)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_jax_ssm_cache_round_trips_into_the_port(param_dtype):
    """A JAX SSM cache (zeros, then after a decode step) carried into the
    port: the port's keys, shapes and dtypes (h f32, conv in the parameter
    dtype), the same values."""
    cj, cp = configs(param_dtype=getattr(jnp, param_dtype))
    cp = dataclasses.replace(cp, param_dtype=getattr(torch, param_dtype))
    B = 2
    zeros = jparams.init_params(jlm.cache_specs(cj, B, 32), jax.random.PRNGKey(0))
    tree = jparams.init_params(jlm.lm_specs(cj), jax.random.PRNGKey(1))
    _, stepped = jlm.decode_step(
        cj, tree, zeros, jnp.array([5, 7], jnp.int32), jnp.array([0, 3], jnp.int32),
        backend="xla",
    )
    specs = plm.cache_specs(cp, B, 0)
    for jtree in (zeros, stepped):
        numpy_tree = jax.tree_util.tree_map(np.asarray, jtree)
        got = carry.cache_from_numpy(cp, numpy_tree, "cpu")
        assert set(got) == set(specs) == {"h", "conv"}
        for name, t in got.items():
            assert tuple(t.shape) == specs[name].shape and t.dtype == specs[name].dtype, name
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(numpy_tree[name], np.float32)
            )
    assert got["h"].dtype == torch.float32 and got["conv"].dtype == cp.param_dtype
    assert float(got["h"].abs().max()) > 0


def tokens_batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batch_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("backend,tol", [("xla", 1e-5), ("interpret", 1e-4)])
def test_forward_matches_jax(backend, tol):
    """S = 256: two 128-row chunks, so the state crosses a chunk."""
    cj, cp = configs()
    tree = jax_weights(cj, seed=12)
    batch = tokens_batch(cj, 2, 256, seed=13)
    loss_j, logits_j = jlm.forward(
        cj, as_jax(tree), {k: jnp.asarray(v) for k, v in batch.items()}, backend=backend
    )
    loss_p, logits_p = plm.forward(cp, carry.from_jax_params(cp, tree, "cpu"), batch_torch(batch))
    assert logits_p.dtype == torch.float32 and logits_p.shape == logits_j.shape
    close_to_scale(logits_p, logits_j, tol)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_gradients_match_jax(remat):
    """Autograd through the port's forward (the SSD scan's plain chunked
    form) against jax.grad of the reference's loss: every gradient within
    1e-4 of its largest magnitude, with and without remat."""
    cj, cp = configs(remat=remat)
    tree = jax_weights(cj, seed=14)
    batch = tokens_batch(cj, 2, 256, seed=15)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.value_and_grad(lambda p: jlm.forward(cj, p, jb, backend="xla")[0])(
        as_jax(tree)
    )
    params = carry.from_jax_params(cp, tree, "cpu")
    loss_p, grads_p = psteps.loss_and_grads(cp, params, batch_torch(batch))
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    paths = [p for p, _ in leaves_with_paths(tree)]
    assert len(paths) == 10
    for path in paths:
        got = get_path(grads_p, path)
        assert got.dtype == get_path(params, path).dtype, path
        close_to_scale(got, get_path(grads_j, path), 1e-4)


def test_three_train_steps_match_jax():
    """make_train_step against jit_train_step from the same carried weights
    and batches, seq 128 (one chunk): losses within 1e-5, parameters within
    1e-5 of their largest magnitude, grad norms within 1e-3; AdamW's eps
    1e-2 as in tests/test_torch_train.py (a continuous update)."""
    cj, cp = configs()
    B, S, steps = 2, 128, 3
    opt_kw = dict(lr=1e-3, eps=1e-2, warmup_steps=1, total_steps=steps)
    shape = JShape(f"train_{S}", S, B, "train")
    jitted, bundle, _ = jsteps.jit_train_step(
        cj, auto_mesh(), shape, opt_cfg=jadamw.AdamWConfig(**opt_kw)
    )
    tree = jax_weights(cj, seed=16)
    jp = jax.device_put(as_jax(tree), bundle["param_sh"])
    jo = jax.device_put(jadamw.init_state(jp, bundle["opt_cfg"]), bundle["opt_sh"])
    step, _ = psteps.make_train_step(cp, padamw.AdamWConfig(**opt_kw))
    pp = carry.from_jax_params(cp, tree, "cpu")
    po = padamw.init_state(pp, padamw.AdamWConfig(**opt_kw))
    source = jpipe.TokenSource(cj, shape, jpipe.DataConfig(seed=0))
    for i in range(steps):
        batch = source.batch_at(i)
        jp, jo, jm = jitted(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        pp, po, pm = step(pp, po, batch_torch(batch))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    for path, want in leaves_with_paths(jax.tree_util.tree_map(np.asarray, jp)):
        close_to_scale(get_path(pp, path), want, 1e-5)


# ---------------------------------------------------------------------------
# the server and the trainer
# ---------------------------------------------------------------------------


def _servers(batch, ctx, seed):
    cj, cp = configs()
    tree = jax_weights(cj, seed=seed)
    js = jserve.BatchedServer(ARCH, batch=batch, ctx=ctx, params=as_jax(tree), mesh=auto_mesh())
    ps = pserve.BatchedServer(
        ARCH, batch=batch, ctx=ctx, params=carry.from_jax_params(cp, tree, "cpu"), device="cpu"
    )
    return js, ps


def _drive(server, queue, batch, max_tokens):
    """serve_requests' loop on a given server: the finished requests'
    tokens, in the order they finish."""
    queue, done = list(queue), []
    while queue or server.active.any():
        for slot in range(batch):
            if not server.active[slot] and queue:
                server.prefill_prompt(slot, queue.pop(0))
        server.decode(max_tokens)
        for slot in range(batch):
            if not server.active[slot] and server.outputs[slot]:
                done.append(server.outputs[slot])
                server.outputs[slot] = []
    return done


def test_server_matches_the_jax_server_through_reused_slots():
    """Five requests through two slots: every request's tokens equal the
    JAX server's, and so do the final SSM states."""
    js, ps = _servers(batch=2, ctx=20, seed=17)
    rng = np.random.default_rng(18)
    queue = [list(rng.integers(1, 512, size=n)) for n in (3, 5, 4, 6, 2)]
    want = _drive(js, queue, 2, 6)
    got = _drive(ps, queue, 2, 6)
    assert len(got) == 5 and got == want
    close_to_scale(ps.cache["h"], js.cache["h"], 1e-5)
    close_to_scale(ps.cache["conv"], js.cache["conv"], 1e-5)


def test_a_reused_slot_keeps_the_previous_requests_state():
    """The reference never resets a slot's recurrent state: a request in a
    reused slot starts from the last request's h and conv (and every
    other slot's stale token steps through its state during a prefill).
    The port copies that behaviour: its tokens and states equal the JAX
    server's, and differ from those of the same request in a fresh slot."""
    js, ps = _servers(batch=2, ctx=32, seed=19)
    rng = np.random.default_rng(20)
    prompts = [list(rng.integers(1, 512, size=n)) for n in (4, 5, 6)]
    for server in (js, ps):
        server.prefill_prompt(0, prompts[0])
        server.prefill_prompt(1, prompts[1])
        server.decode(3)
        server.active[0] = False  # retire slot 0, reuse it
        server.prefill_prompt(0, prompts[2])
        server.decode(4)
    assert ps.outputs == js.outputs
    assert np.array_equal(ps.pos, js.pos)
    close_to_scale(ps.cache["h"], js.cache["h"], 1e-5)
    _, fresh = _servers(batch=2, ctx=32, seed=19)
    fresh.prefill_prompt(0, prompts[2])
    fresh.decode(4)
    assert not torch.allclose(fresh.cache["h"][:, 0], ps.cache["h"][:, 0], rtol=1e-3, atol=1e-3)


def test_serve_requests_runs_the_ssm_family(monkeypatch):
    """serve_requests on mamba2-130m-smoke completes the JAX driver's
    requests with the same token counts."""
    monkeypatch.setattr(jserve, "make_host_mesh", lambda **kw: auto_mesh())
    kw = dict(batch=2, ctx=24, n_requests=3, max_tokens=4, seed=0)
    want = jserve.serve_requests(ARCH, **kw)
    got = pserve.serve_requests(ARCH, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])
    assert got["completed"] == 3 and got["steps"] >= len(got["step_s"]) > 0


def test_train_runs_the_ssm_family_on_the_cpu(capsys):
    out = ptrain.train(ARCH, steps=2, batch=2, seq=128, log_every=1, device="cpu")
    assert np.all(np.isfinite(out["losses"])) and np.all(np.isfinite(out["grad_norms"]))
    assert out["params"]["layers"]["mamba"]["w_in"].device.type == "cpu"
    assert capsys.readouterr().out.count(f"[train {ARCH}] step") == 2


@pytest.mark.parametrize("arch", [ARCH, GRANITE])
def test_clis_run_on_the_cpu(capsys, arch):
    ptrain.main(["--arch", arch, "--steps", "1", "--batch", "1", "--seq", "64", "--device", "cpu"])
    assert "done: final_step=0" in capsys.readouterr().out
    pserve.main(["--arch", arch, "--batch", "1", "--ctx", "12", "--requests", "1",
                 "--tokens", "2", "--device", "cpu"])
    assert "served 1 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch,cache", [(ARCH, {"h", "conv"}), (GRANITE, {"k", "v"})])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, arch, cache):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserve.BatchedServer(arch, batch=1, ctx=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserve.serve_requests(arch, batch=1, ctx=8, n_requests=1, max_tokens=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.train(arch, steps=1, batch=1, seq=16)
    server = pserve.BatchedServer(arch, batch=1, ctx=8, device="cpu")
    assert set(server.cache) == cache
    assert all(t.device.type == "cpu" for t in server.cache.values())


@pytest.mark.parametrize(
    "arch,item",
    [
        ("zamba2-1.2b-smoke", "A.7"),
        ("granite-moe-1b-a400m-smoke", "A.7"),
        ("llava-next-34b-smoke", "A.7"),
        ("seamless-m4t-large-v2-smoke", "A.7"),
        ("deepseek-moe-16b-smoke", "A.7"),
    ],
)
def test_unported_families_and_norms_still_raise(arch, item):
    """ROADMAP ``item`` ported the hybrid, MoE, VLM and encoder-decoder
    families (A.7.1-A.7.4): their spec trees (``steps.model_specs``) equal
    the reference's.  ``lm.lm_specs`` of the encoder-decoder family raises
    ``ValueError`` in both packages: its tree is ``encdec.encdec_specs``."""
    if arch.startswith("seamless"):
        with pytest.raises(ValueError, match="encdec"):
            plm.lm_specs(preg.get(arch))
        with pytest.raises(ValueError, match="encdec"):
            jlm.lm_specs(jreg.get(arch))
    sj = jax.tree_util.tree_leaves_with_path(
        jsteps.model_specs(jreg.get(arch)), is_leaf=jparams.is_spec
    )
    flat = {jax.tree_util.keystr(path): s for path, s in sj}
    port = {
        jax.tree_util.keystr(path): s
        for path, s in jax.tree_util.tree_leaves_with_path(
            psteps.model_specs(preg.get(arch)), is_leaf=pparams.is_spec
        )
    }
    assert set(port) == set(flat)
    for key, s in port.items():
        assert s.shape == flat[key].shape and s.init == flat[key].init, key
        assert str(s.dtype) == f"torch.{jnp.dtype(flat[key].dtype)}", key


def test_ssm_spec_tree_matches_the_reference():
    cj, cp = configs()
    sj = jax.tree_util.tree_leaves_with_path(jlm.lm_specs(cj), is_leaf=jparams.is_spec)
    flat = {jax.tree_util.keystr(path): s for path, s in sj}
    port = {
        jax.tree_util.keystr(path): s
        for path, s in jax.tree_util.tree_leaves_with_path(plm.lm_specs(cp), is_leaf=pparams.is_spec)
    }
    assert set(port) == set(flat)
    for key, s in port.items():
        assert s.shape == flat[key].shape and s.init == flat[key].init, key
        assert str(s.dtype) == f"torch.{jnp.dtype(flat[key].dtype)}", key
