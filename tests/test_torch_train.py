"""The port's training path against the JAX package, on the CPU.

Configs: ``qwen2.5-14b-smoke`` (f32, vocab 512, GQA 4/2 heads of 16 with
QKV bias), and for the forward, the gradients and the train steps also
``granite-20b-smoke`` (layer norms with biases, MQA: 4 query heads over 1
kv head, the gelu MLP).  Weights come from the JAX package's
``init_params``; the QKV biases, the norm weights and the norm biases,
which it initialises to zeros and ones, are overwritten with random
values so their paths are tested; then the same numpy tree is carried
into the port (``models.carry``).  Inputs are drawn from seeded numpy
generators and handed to both packages.

- the port's plain ``ref.attention`` matches the Pallas ``flash_attention``
  (``interpret=True``) on the sweeps of ``tests/test_kernels.py`` at 1e-4,
  and the JAX plain version, chunked, at 1e-5;
- ``attention_apply`` and ``forward`` (loss and logits) match the JAX
  functions with ``backend="xla"`` and ``backend="interpret"``, which
  runs the Pallas kernels;
- autograd's gradients of the loss match the port's own in f64 within
  1e-4 of each tensor's largest magnitude, and ``jax.grad`` of the
  reference's within 1e-4 (granite: 2e-4), with and without remat;
- ``adamw.update`` and ``schedule`` match the reference's at 1e-6;
- ``TokenSource.batch_at`` equals the reference's bit for bit;
- three steps of ``make_train_step`` match the reference's
  ``jit_train_step`` (losses, grad norms, parameters);
- ``train(..., device="cpu")`` runs end to end, with ``ckpt_dir=`` too.

The JAX train step is built on a mesh with Auto axes: the reference's
default mesh fails under the installed JAX (ROADMAP queue C).
"""

import dataclasses
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jpipe
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.optim import adamw as jadamw
from repro.parallel import steps as jsteps
from repro_torch.configs import registry as preg
from repro_torch.configs.base import ShapeConfig as PShape
from repro_torch.data import pipeline as ppipe
from repro_torch.ft import watchdog as pwatch
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ptrain
from repro_torch.models import carry
from repro_torch.models import layers as pL
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams
from repro_torch.optim import adamw as padamw
from repro_torch.parallel import steps as psteps

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-14b-smoke"
GRANITE = "granite-20b-smoke"  # norm="ln" (norm biases), MQA, the gelu MLP
TOL = dict(rtol=1e-5, atol=1e-5)


def configs(arch=ARCH, **changes):
    cj, cp = jreg.get(arch), preg.get(arch)
    if changes:
        cj = dataclasses.replace(cj, **changes)
        cp = dataclasses.replace(cp, **changes)
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
    return jax.tree_util.tree_map(jnp.asarray, tree)


def auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def tokens_batch(cfg, B, S, seed=0):
    """tokens and labels (B, S) int32, drawn with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


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


# ---------------------------------------------------------------------------
# the plain attention against the Pallas kernel and the JAX plain version
# ---------------------------------------------------------------------------


def rand(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("S,H,Hkv,D", [(256, 4, 4, 64), (256, 8, 2, 64), (128, 4, 1, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_pallas(S, H, Hkv, D, causal):
    rng = np.random.default_rng(S + H + Hkv + D)
    q, k, v = rand(rng, (S, H, D), 0.5), rand(rng, (S, Hkv, D), 0.5), rand(rng, (S, Hkv, D), 0.5)
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, bq=64, bk=64,
        interpret=True,
    )
    got = ref.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    close(got, want, rtol=1e-4, atol=1e-4)


def test_plain_attention_windowed_matches_pallas():
    rng = np.random.default_rng(7)
    S, H, D = 256, 2, 64
    q, k, v = (rand(rng, (S, H, D)) for _ in range(3))
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=64, bq=64, bk=64,
        interpret=True,
    )
    got = ref.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True, window=64
    )
    close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300), (False, 0)])
def test_plain_attention_in_query_chunks_matches_jax(causal, window):
    """S = 2,048 > the 1,024-query chunk: both versions run their chunked
    path; a batch axis equals the sequences one by one."""
    rng = np.random.default_rng(11)
    B, S, H, Hkv, D = 2, 2048, 4, 2, 16
    q, k, v = rand(rng, (B, S, H, D)), rand(rng, (B, S, Hkv, D)), rand(rng, (B, S, Hkv, D))
    got = ref.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal, window=window
    )
    for b in range(B):
        want = jref.attention(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), causal=causal, window=window
        )
        close(got[b], want)


def test_plain_attention_refuses_a_ragged_chunk():
    x = torch.zeros(1500, 2, 16)
    with pytest.raises(ValueError, match="q_chunk"):
        ref.attention(x, x, x)


def test_plain_attention_keeps_bf16():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rand(rng, (64, 4, 16))).to(torch.bfloat16)
    k = torch.from_numpy(rand(rng, (64, 2, 16))).to(torch.bfloat16)
    got = ref.attention(q, k, k)
    want = jref.attention(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(k.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(k.float().numpy()).astype(jnp.bfloat16),
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=1e-6
    )


def test_cpu_gradients_are_autograds_and_launch_nothing():
    """On CPU tensors the differentiable ops are the plain versions: their
    gradients are autograd's, equal to the plain backward functions, and
    no kernel is counted."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rand(rng, (2, 64, 4, 16))).requires_grad_(True)
    k = torch.from_numpy(rand(rng, (2, 64, 2, 16))).requires_grad_(True)
    v = torch.from_numpy(rand(rng, (2, 64, 2, 16))).requires_grad_(True)
    do = torch.from_numpy(rand(rng, (2, 64, 4, 16)))
    out = ops.attention(q, k, v, causal=True, window=16)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = ref.attention_bwd(q, k, v, do, causal=True, window=16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    x = torch.from_numpy(rand(rng, (6, 33))).requires_grad_(True)
    w = torch.from_numpy(1 + rand(rng, (33,), 0.3)).requires_grad_(True)
    dy = torch.from_numpy(rand(rng, (6, 33)))
    got = torch.autograd.grad(ops.rmsnorm(x, w), (x, w), dy)
    want = ref.rmsnorm_bwd(x, w, dy)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    b = torch.from_numpy(rand(rng, (33,), 0.3)).requires_grad_(True)
    got = torch.autograd.grad(ops.layernorm(x, w, b), (x, w, b), dy)
    want = ref.layernorm_bwd(x, w, b, dy)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    assert set(ops.launch_counts().values()) == {0}


def test_plain_rmsnorm_bwd_matches_jax_grad():
    rng = np.random.default_rng(9)
    x, w, dy = rand(rng, (5, 48)), 1 + rand(rng, (48,), 0.3), rand(rng, (5, 48))
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b), jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    got = ref.rmsnorm_bwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy))
    for g, wt in zip(got, want):
        close(g, wt)


# ---------------------------------------------------------------------------
# the model's training forward and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,tol", [("xla", 1e-5), ("interpret", 1e-4)])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_apply_matches_jax(backend, tol, window):
    cj, cp = configs()
    tree = jax_weights(cj, seed=1)
    lj = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree["layers"]["attn"])
    lp = pparams.tree_map(lambda a: torch.from_numpy(np.array(a[0])), tree["layers"]["attn"])
    rng = np.random.default_rng(2)
    B, S = 2, 32
    x = rng.normal(size=(B, S, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jL.attention_apply(
        lj, jnp.asarray(x), jnp.asarray(pos), cfg=cj, window=window, backend=backend
    )
    got = pL.attention_apply(
        lp, torch.from_numpy(x), torch.from_numpy(pos.copy()), cfg=cp, window=window
    )
    close_to_scale(got, want, tol)


@pytest.mark.parametrize("arch", [ARCH, GRANITE])
@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_forward_matches_jax(backend, arch):
    """Logits within 1e-4 of their largest magnitude, the loss within 1e-5:
    the two frameworks' f32 rope frequencies part by an ulp (ROADMAP queue
    C), which positions up to 63 lift to ~2e-5 of the logits' scale after
    two layers (the JAX package's own two paths part by ~3e-6)."""
    cj, cp = configs(arch)
    tree = jax_weights(cj, seed=3)
    batch = tokens_batch(cj, 2, 64, seed=4)
    loss_j, logits_j = jlm.forward(
        cj, as_jax(tree), {k: jnp.asarray(v) for k, v in batch.items()}, backend=backend
    )
    params = carry.from_jax_params(cp, tree, "cpu")
    loss_p, logits_p = plm.forward(cp, params, to_torch(batch))
    assert logits_p.dtype == torch.float32 and logits_p.shape == logits_j.shape
    close_to_scale(logits_p, logits_j, 1e-4)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


def test_cross_entropy_matches_jax_with_invalid_labels():
    rng = np.random.default_rng(6)
    logits = rand(rng, (2, 5, 768), 3.0)
    labels = rng.integers(0, 512, size=(2, 5)).astype(np.int32)
    labels[0, 1], labels[1, 3] = -1, 600  # outside [0, vocab): not counted
    want = jL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 512)
    got = pL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), 512)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.parametrize("arch,n_leaves,jax_rtol", [(ARCH, 14, 1e-4), (GRANITE, 13, 2e-4)])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_gradients_match_jax(remat, arch, n_leaves, jax_rtol):
    """Autograd through the port's forward against jax.grad of the
    reference's loss, and against the port's own gradients in f64: every
    gradient within jax_rtol and 1e-4 of its largest magnitude.
    ``remat="full"`` runs each layer under torch.utils.checkpoint in the
    port and jax.checkpoint in the reference.

    Both sides are f32 computations of a model that amplifies rounding:
    the reference's init (fan_in = the head count for wq and wk) makes the
    attention nearly one-hot.  On granite each side's gradients lie up to
    ~9e-5 of their largest magnitude from f64, so the two are held within
    2e-4 of each other (their distances from f64 added)."""
    cj, cp = configs(arch, remat=remat)
    tree = jax_weights(cj, seed=5)
    batch = tokens_batch(cj, 2, 64, seed=6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.value_and_grad(lambda p: jlm.forward(cj, p, jb, backend="xla")[0])(
        as_jax(tree)
    )
    params = carry.from_jax_params(cp, tree, "cpu")
    loss_p, grads_p = psteps.loss_and_grads(cp, params, to_torch(batch))
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    cp64 = dataclasses.replace(cp, param_dtype=torch.float64)
    p64 = pparams.tree_map(lambda t: t.double(), params)
    _, grads_64 = psteps.loss_and_grads(cp64, p64, to_torch(batch))
    paths = [p for p, _ in leaves_with_paths(tree)]
    assert len(paths) == n_leaves
    for path in paths:
        got = get_path(grads_p, path)
        assert got.dtype == get_path(params, path).dtype, path
        close_to_scale(got, get_path(grads_64, path).numpy(), 1e-4)
        close_to_scale(got, get_path(grads_j, path), jax_rtol)


# ---------------------------------------------------------------------------
# the optimizer and the data
# ---------------------------------------------------------------------------


def small_tree(rng):
    return {
        "a": {"w": rand(rng, (7, 5)), "b": rand(rng, (5,))},
        "z": rand(rng, (3, 2, 4)),
    }


@pytest.mark.parametrize("grad_compress", [False, True])
def test_adamw_update_matches_jax(grad_compress):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_compress=grad_compress)
    jcfg, pcfg = jadamw.AdamWConfig(**cfg_kw), padamw.AdamWConfig(**cfg_kw)
    rng = np.random.default_rng(int(grad_compress))
    params = small_tree(rng)
    jp = as_jax(params)
    pp = pparams.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    js, ps = jadamw.init_state(jp, jcfg), padamw.init_state(pp, pcfg)
    for step in range(4):
        grads = small_tree(rng)
        grads["a"]["w"] *= 10.0 ** step  # the clip engages from step 1
        jp, js, jm = jadamw.update(as_jax(grads), js, jp, jcfg)
        pp, ps, pm = padamw.update(
            pparams.tree_map(torch.from_numpy, grads), ps, pp, pcfg
        )
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-6)
        assert int(ps["step"]) == int(js["step"]) == step + 1
        trees = [(pp, jp), (ps["m"], js["m"]), (ps["v"], js["v"])]
        if grad_compress:
            trees.append((ps["err"], js["err"]))
        for got_tree, want_tree in trees:
            for path, want in leaves_with_paths(want_tree):
                close(get_path(got_tree, path), want, rtol=1e-6, atol=1e-6)


def test_adamw_keeps_bf16_params_and_takes_bf16_grads():
    cfg = padamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    p = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    st = padamw.init_state(p, cfg)
    assert st["m"]["w"].dtype == torch.float32 and st["step"].dtype == torch.int32
    g = {"w": torch.full((4, 3), 0.5, dtype=torch.bfloat16)}
    p2, st2, m = padamw.update(g, st, p, cfg)
    assert p2["w"].dtype == torch.bfloat16 and p2["w"] is p["w"]
    assert float(p2["w"][0, 0]) < 1.0 and int(st2["step"]) == 1


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (0, 50), (5, 5)])
def test_schedule_matches_jax(warmup, total):
    jcfg = jadamw.AdamWConfig(warmup_steps=warmup, total_steps=total)
    pcfg = padamw.AdamWConfig(warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 3, 5, 50, 99, 100, 101, 2500, 9999, 10_000, 20_000):
        want = float(jadamw.schedule(jcfg, jnp.int32(step)))
        got = float(padamw.schedule(pcfg, torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize(
    "arch", ["qwen2.5-14b-smoke", "llava-next-34b-smoke", "seamless-m4t-large-v2-smoke"]
)
@pytest.mark.parametrize("seed", [0, 3])
def test_token_source_matches_jax_bitwise(arch, seed):
    shape_args = ("train_64", 64, 3, "train")
    src_j = jpipe.TokenSource(jreg.get(arch), JShape(*shape_args), jpipe.DataConfig(seed=seed))
    src_p = ppipe.TokenSource(preg.get(arch), PShape(*shape_args), ppipe.DataConfig(seed=seed))
    for step in (0, 1, 17):
        bj, bp = src_j.batch_at(step), src_p.batch_at(step)
        assert sorted(bj) == sorted(bp)
        for key in bj:
            assert bj[key].dtype == bp[key].dtype and np.array_equal(bj[key], bp[key]), key


def test_token_file_source_matches_jax_bitwise(tmp_path):
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(0).integers(0, 70000, size=5000).astype(np.uint32))
    shape_args = ("train_32", 32, 4, "train")
    src_j = jpipe.TokenSource(
        jreg.get(ARCH), JShape(*shape_args), jpipe.DataConfig(kind="file", path=str(path))
    )
    src_p = ppipe.TokenSource(
        preg.get(ARCH), PShape(*shape_args), ppipe.DataConfig(kind="file", path=str(path))
    )
    for step in (0, 5):
        bj, bp = src_j.batch_at(step), src_p.batch_at(step)
        for key in bj:
            assert np.array_equal(bj[key], bp[key]), key
    with pytest.raises(ValueError, match="path"):
        ppipe.TokenSource(preg.get(ARCH), PShape(*shape_args), ppipe.DataConfig(kind="file"))


@pytest.mark.parametrize("module", ["data/pipeline.py", "ft/watchdog.py"])
def test_copied_modules_keep_the_reference_code(module):
    """The port's copies differ from the reference only in the module
    docstring (and a stray character in a comment)."""

    def body(pkg):
        text = (ROOT / "src" / pkg / module).read_text()
        code = text[text.index('"""', 3) + 3 :]
        return code.replace("with局 local", "with local")

    assert body("repro_torch") == body("repro")


def test_watchdog_injector_and_retry_loop():
    inj = pwatch.FailureInjector({1: RuntimeError("boom")})
    inj.maybe_fail(0)
    with pytest.raises(RuntimeError, match="boom"):
        inj.maybe_fail(1)
    inj.maybe_fail(1)  # fires once

    class Ckpt:
        def __init__(self):
            self.step = None

        def latest_step(self):
            return self.step

        def wait(self):
            pass

    ckpt, starts = Ckpt(), []

    def run_from(start):
        starts.append(start)
        if len(starts) == 1:
            ckpt.step = 4
            raise ValueError("worker fault")
        return 9

    assert pwatch.retry_loop(run_from, ckpt_mgr=ckpt) == 9
    assert starts == [0, 5]
    wd = pwatch.StepWatchdog(0.0, max_strikes=1)
    wd.start(0)
    for _ in range(200):
        if wd.fired:
            break
        time.sleep(0.01)
    wd.stop()
    with pytest.raises(TimeoutError, match="straggler"):
        wd.check()


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, GRANITE])
def test_three_train_steps_match_jax(arch):
    """make_train_step against the reference's jit_train_step from the same
    carried weights and batches: losses within 1e-5, every parameter within
    1e-5 of its largest magnitude, grad norms within 1e-3.

    The learning rate is 1e-3 from the first step, so the parameters move
    and steps 2 and 3 see different weights.  AdamW's eps is 1e-2, so the
    update is continuous in the gradient: with the default 1e-8 an entry
    whose gradient is within rounding of zero moves by +-lr on its sign,
    and the frameworks' last-bit differences flip some.  The grad norm's
    1e-3: the reference's init (fan_in = the head count for wq and wk)
    makes the smoke model's attention nearly one-hot, so f32 rounding of
    the logits moves the gradients by ~5e-5 of their norm, and by 4.7e-4
    at the third step here."""
    cj, cp = configs(arch)
    B, S, steps = 2, 64, 3
    opt_kw = dict(lr=1e-3, eps=1e-2, warmup_steps=1, total_steps=steps)
    shape = JShape(f"train_{S}", S, B, "train")
    mesh = auto_mesh()
    jitted, bundle, _ = jsteps.jit_train_step(cj, mesh, shape, opt_cfg=jadamw.AdamWConfig(**opt_kw))
    tree = jax_weights(cj, seed=7)
    jp = jax.device_put(as_jax(tree), bundle["param_sh"])
    jo = jax.device_put(jadamw.init_state(jp, bundle["opt_cfg"]), bundle["opt_sh"])
    step, specs = psteps.make_train_step(cp, padamw.AdamWConfig(**opt_kw))
    assert set(specs) == set(tree)
    pp = carry.from_jax_params(cp, tree, "cpu")
    po = padamw.init_state(pp, padamw.AdamWConfig(**opt_kw))
    source = jpipe.TokenSource(cj, shape, jpipe.DataConfig(seed=0))
    for i in range(steps):
        batch = source.batch_at(i)
        jp, jo, jm = jitted(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        pp, po, pm = step(pp, po, to_torch(batch))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), rtol=1e-6)
    for path, want in leaves_with_paths(jax.tree_util.tree_map(np.asarray, jp)):
        close_to_scale(get_path(pp, path), want, 1e-5)


def test_train_runs_on_the_cpu_end_to_end(capsys):
    out = ptrain.train(ARCH, steps=3, batch=2, seq=64, log_every=1, device="cpu")
    assert out["final_step"] == 2 and len(out["losses"]) == 3
    assert np.all(np.isfinite(out["losses"])) and np.all(np.isfinite(out["grad_norms"]))
    assert len(out["step_s"]) == 3 and out["init_s"] >= 0
    assert out["params"]["embed"]["tok"].device.type == "cpu"
    gen = torch.Generator().manual_seed(0)
    init = pparams.init_params(plm.lm_specs(preg.get(ARCH)), gen, "cpu")
    assert not torch.equal(init["layers"]["attn"]["wq"], out["params"]["layers"]["attn"]["wq"])
    assert capsys.readouterr().out.count("[train qwen2.5-14b-smoke] step") == 3
    # the same run again gives the same losses: weights and data from the seed
    again = ptrain.train(ARCH, steps=3, batch=2, seq=64, log_every=10, device="cpu")
    assert again["losses"] == out["losses"]


def test_train_starts_from_the_weights_it_is_given():
    """``train(params=)`` starts from a copy of the given weights: its first
    loss is theirs on the step-0 batch, and the caller's tensors are left
    as they were."""
    cfg = dataclasses.replace(preg.get(ARCH), n_layers=1, name="one-layer")
    params = pparams.init_params(psteps.model_specs(cfg), torch.Generator().manual_seed(3), "cpu")
    before = pparams.tree_map(lambda t: t.clone(), params)
    out = ptrain.train(cfg, steps=2, batch=1, seq=32, params=params, device="cpu")
    for got, want in zip(pparams.tree_leaves(params), pparams.tree_leaves(before)):
        assert torch.equal(got, want)
    shape = PShape("train_32", 32, 1, "train")
    batch = ppipe.TokenSource(cfg, shape, ppipe.DataConfig(seed=0)).batch_at(0)
    loss, _ = psteps.loss_and_grads(cfg, params, to_torch(batch))
    assert out["losses"][0] == float(loss)


def test_train_takes_a_model_config_and_an_injector():
    cfg = dataclasses.replace(preg.get(ARCH), n_layers=1, name="one-layer")
    out = ptrain.train(cfg, steps=1, batch=1, seq=32, device="cpu")
    assert out["params"]["layers"]["attn"]["wq"].shape[0] == 1
    inj = pwatch.FailureInjector({1: RuntimeError("drill")})
    with pytest.raises(RuntimeError, match="drill"):
        ptrain.train(cfg, steps=3, batch=1, seq=32, injector=inj, device="cpu")


def test_train_refuses_what_is_not_ported(tmp_path):
    """Checkpointing (ROADMAP A.8) and the encoder-decoder family (A.7.4)
    are ported: ``train`` saves to ``ckpt_dir`` and trains seamless."""
    out = ptrain.train(ARCH, steps=2, batch=1, seq=32, ckpt_dir=str(tmp_path), ckpt_every=1,
                       device="cpu")
    assert out["final_step"] == 1 and len(out["losses"]) == 2
    assert (tmp_path / "LATEST").read_text() == "step_00000001"
    out = ptrain.train("seamless-m4t-large-v2-smoke", steps=1, batch=1, seq=32, device="cpu")
    assert out["params"]["enc_layers"]["attn"]["wq"].shape[0] == 2
    assert all(np.isfinite(out["losses"]))
