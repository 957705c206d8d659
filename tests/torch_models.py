"""Shared helpers of the model-family parity tests (MoE, hybrid, VLM,
encoder-decoder):
both packages' configs, the JAX package's weights carried into the port,
tolerance checks, spec-tree comparison and the Auto-axes mesh the JAX
steps need (ROADMAP queue C: the reference's default mesh fails under
the installed JAX).

Weights come from the JAX package's ``init_params`` of its family's spec
tree (``steps.model_specs``); the leaves it
initialises to constants (norm weights and biases, attention biases,
Mamba2's ``A_log``, ``dt_bias``, ``D`` and inner norm) are overwritten
with random values so that their paths are tested (``A = -exp(A_log)``
stays negative), and the same numpy tree goes to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.parallel import steps as jsteps
from repro_torch.configs import registry as preg
from repro_torch.models import carry
from repro_torch.models import encdec as pencdec
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams


def configs(arch, **changes):
    """The JAX and port configs of ``arch``, with ``changes`` applied to
    both."""
    cj, cp = jreg.get(arch), preg.get(arch)
    if changes:
        cj = dataclasses.replace(cj, **changes)
        cp = dataclasses.replace(cp, **changes)
    return cj, cp


def published_f32(arch, n_layers=1):
    """``arch`` at its published widths, cut to ``n_layers`` (an
    encoder-decoder model's encoder too), in f32 on both sides."""
    cuts = dict(n_layers=n_layers)
    if jreg.get(arch).enc_layers:
        cuts["enc_layers"] = n_layers
    cj, cp = configs(arch, **cuts)
    return (
        dataclasses.replace(cj, param_dtype=jnp.float32),
        dataclasses.replace(cp, param_dtype=torch.float32),
    )


def check_forward_and_decode(cj, cp, seed=1):
    """``forward`` (B 1, S 64) and one decode step on a stale cache against
    the reference's plain path: logits within 1e-4 of their scale (rope's
    ulp, as in ``tests/test_torch_train.py``), the loss within 1e-5, the
    decode logits within 1e-5."""
    pj, pp = both_weights(cj, cp, seed=seed)
    batch = tokens_batch(cj, 1, 64, seed=seed + 1)
    (loss_j, logits_j), (loss_p, logits_p) = forward_both(cj, cp, pj, pp, batch, "xla")
    close_to_scale(logits_p, logits_j, 1e-4)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    cache_j, cache_p = random_caches(cj, cp, 2, 32, seed=seed + 2, scale=0.5)
    toks, pos = np.array([5, 17], np.int32), np.array([3, 31], np.int32)
    want, _ = jlm.decode_step(cj, pj, cache_j, jnp.asarray(toks), jnp.asarray(pos), backend="xla")
    got, _ = plm.decode_step(cp, pp, cache_p, torch.from_numpy(toks), torch.from_numpy(pos))
    close_to_scale(got, want, 1e-5)


def _randomise(tree, rng) -> None:
    def draw(shape, mean, scale):
        return (mean + scale * rng.normal(size=shape)).astype(np.float32)

    for name in list(tree):
        sub = tree[name]
        if isinstance(sub, dict):
            _randomise(sub, rng)
        elif name in ("ln1", "ln2", "lnx", "final_norm", "enc_norm", "norm", "D"):
            tree[name] = draw(sub.shape, 1.0, 0.3)
        elif name.endswith("_b") or name in ("bq", "bk", "bv", "A_log"):
            tree[name] = draw(sub.shape, 0.0, 0.3 if name != "A_log" else 0.5)
        elif name == "dt_bias":
            tree[name] = draw(sub.shape, 0.0, 0.5)


def jax_weights(cfg_j, seed=0, model_fan_in=False):
    """The JAX package's weights as numpy, the constant inits randomised;
    with ``model_fan_in`` every attention block's ``wq`` and ``wk`` at a
    fan-in of d_model (:func:`at_model_fan_in`)."""
    tree = jparams.init_params(jsteps.model_specs(cfg_j), jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    _randomise(tree, np.random.default_rng(seed + 100))
    if model_fan_in:
        for attn in _attention_blocks(tree):
            at_model_fan_in(attn)
    return tree


def _attention_blocks(tree):
    for sub in tree.values():
        if isinstance(sub, dict):
            yield from [sub] if "wq" in sub else _attention_blocks(sub)


def at_model_fan_in(attn) -> None:
    """Redraw an attention block's ``wq`` and ``wk`` (d, H, Dh), or a
    stack of them (L, d, H, Dh), at a fan-in of d_model, where the
    reference's init takes the head count (``shape[-2]``): its attention
    is then nearly one-hot, which amplifies f32 rounding layer after
    layer.  Scales them in place."""
    for name in ("wq", "wk"):
        w = attn[name]
        attn[name] = (w * np.sqrt(w.shape[-2] / w.shape[-3])).astype(w.dtype)


def both_weights(cj, cp, seed=0, model_fan_in=False):
    """``(JAX params, port params)`` from the same numpy tree."""
    tree = jax_weights(cj, seed, model_fan_in)
    return as_jax(tree), carry.from_jax_params(cp, tree, "cpu")


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


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


def assert_same_specs(port_tree, jax_tree):
    """Same leaves by path, each with the same shape, init and dtype."""
    port = dict(leaves_with_paths(port_tree))
    flat = dict(leaves_with_paths(jax_tree))
    assert set(port) == set(flat)
    for key, s in port.items():
        assert s.shape == flat[key].shape and s.init == flat[key].init, key
        assert str(s.dtype) == f"torch.{jnp.dtype(flat[key].dtype)}", key


def tokens_batch(cfg, B, S, seed=0):
    """tokens and labels (B, S) int32, and the frontend embeddings (B, Nf,
    d) f32 for a model that takes them ((B, S, d) frames for an
    encoder-decoder model), drawn with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frontend"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    elif cfg.n_frontend_tokens:
        fe = rng.normal(size=(B, cfg.n_frontend_tokens, cfg.d_model))
        batch["frontend"] = fe.astype(np.float32)
    return batch


def random_caches(cj, cp, B, S, seed, scale=1.0):
    """A stale cache of the JAX layout drawn with numpy: ``(JAX cache,
    port cache)``."""
    rng = np.random.default_rng(seed)
    specs = jlm.cache_specs(cj, B, S)
    tree = {
        k: (scale * rng.normal(size=s.shape)).astype(np.float32) for k, s in specs.items()
    }
    return as_jax(tree), carry.cache_from_numpy(cp, tree, "cpu")


def forwards(cj):
    """The reference's and the port's training forward of ``cj``'s
    family."""
    if cj.family == "encdec":
        return jencdec.forward, pencdec.forward
    return jlm.forward, plm.forward


def forward_both(cj, cp, pj, pp, batch, backend):
    """``((loss, logits) of the reference, (loss, logits) of the port)``."""
    jfwd, pfwd = forwards(cj)
    want = jfwd(cj, pj, {k: jnp.asarray(v) for k, v in batch.items()}, backend=backend)
    got = pfwd(cp, pp, to_torch(batch))
    return want, got


def grads_both(cj, cp, tree_np, batch):
    """``jax.grad`` of the reference's loss, and the port's gradients in
    f32 and in f64, from the same weights: ``(loss_j, grads_j, loss_p,
    grads_p, grads_64, params_p)``."""
    from repro_torch.parallel import steps as psteps

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jfwd = forwards(cj)[0]
    loss_j, grads_j = jax.value_and_grad(lambda p: jfwd(cj, p, jb, backend="xla")[0])(
        as_jax(tree_np)
    )
    params = carry.from_jax_params(cp, tree_np, "cpu")
    loss_p, grads_p = psteps.loss_and_grads(cp, params, to_torch(batch))
    cp64 = dataclasses.replace(cp, param_dtype=torch.float64)
    p64 = pparams.tree_map(lambda t: t.double(), params)
    _, grads_64 = psteps.loss_and_grads(cp64, p64, to_torch(batch))
    return loss_j, grads_j, loss_p, grads_p, grads_64, params


def check_grads(cj, cp, tree_np, batch, jax_rtol=2e-4):
    """The port's gradients of the loss against its own in f64, within
    1e-4 of each leaf's largest magnitude, and against ``jax.grad`` of the
    reference's within ``jax_rtol``; the losses within 1e-5.

    Why 2e-4 against JAX: the reference's init (fan_in = the head count
    for wq and wk) makes the smoke models' attention nearly one-hot, and
    f32 rounding there moves a gradient by up to ~1.7e-4 of its scale from
    f64 on the JAX side (the MoE smoke twins' wk, router and embedding),
    while the port's stay within 1e-4 of f64: the two are held within the
    sum of their distances, as granite's are in
    ``tests/test_torch_train.py`` (ROADMAP C.4)."""
    loss_j, grads_j, loss_p, grads_p, grads_64, params = grads_both(cj, cp, tree_np, batch)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for path, _ in leaves_with_paths(tree_np):
        got = get_path(grads_p, path)
        assert got.dtype == get_path(params, path).dtype, path
        close_to_scale(got, get_path(grads_64, path).numpy(), 1e-4)
        close_to_scale(got, get_path(grads_j, path), jax_rtol)
    return grads_p


def train_steps_both(arch, steps=3, B=2, S=64, seed=7, model_fan_in=False):
    """Three steps of the port's ``make_train_step`` beside the reference's
    ``jit_train_step`` from the same carried weights (``jax_weights``) and
    batches (the reference's token source, frontend included), at the
    settings of ``tests/test_torch_train.py``: lr 1e-3 from the first
    step, AdamW eps 1e-2.  Yields ``(port metrics, JAX metrics)`` a step,
    then the final ``(port params, JAX params as numpy)``."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.data import pipeline as jpipe
    from repro.optim import adamw as jadamw
    from repro.parallel import steps as jsteps
    from repro_torch.optim import adamw as padamw
    from repro_torch.parallel import steps as psteps

    cj, cp = configs(arch)
    opt_kw = dict(lr=1e-3, eps=1e-2, warmup_steps=1, total_steps=steps)
    shape = JShape(f"train_{S}", S, B, "train")
    jitted, bundle, _ = jsteps.jit_train_step(
        cj, auto_mesh(), shape, opt_cfg=jadamw.AdamWConfig(**opt_kw)
    )
    tree = jax_weights(cj, seed=seed, model_fan_in=model_fan_in)
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
        yield pm, jm
    yield pp, jax.tree_util.tree_map(np.asarray, jp)


def servers(arch, batch, ctx, seed=10):
    """The JAX ``BatchedServer`` on the Auto-axes mesh and the port's on
    the CPU, from the same weights."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as pserve

    cj, cp = configs(arch)
    tree = jax_weights(cj, seed=seed)
    js = jserve.BatchedServer(arch, batch=batch, ctx=ctx, params=as_jax(tree), mesh=auto_mesh())
    ps = pserve.BatchedServer(
        arch, batch=batch, ctx=ctx, params=carry.from_jax_params(cp, tree, "cpu"), device="cpu"
    )
    return js, ps


def same_state(js, ps):
    assert np.array_equal(ps.pos, js.pos), (ps.pos, js.pos)
    assert np.array_equal(ps.active, js.active)
    assert np.array_equal(ps.tokens, js.tokens)
    assert ps.outputs == js.outputs


def drive_servers(js, ps, vocab, seed=11):
    """Prefills, decodes, a slot retired and refilled mid-flight, through
    both servers; their tokens, positions and outputs equal at each
    stage."""
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(1, vocab, size=n)) for n in (3, 4, 5)]
    for server in (js, ps):
        server.prefill_prompt(0, prompts[0])
        server.prefill_prompt(1, prompts[1])
    same_state(js, ps)
    for server in (js, ps):
        server.decode(5)
    same_state(js, ps)
    for server in (js, ps):
        server.active[0] = False  # retire slot 0, refill it mid-flight
        server.prefill_prompt(0, prompts[2])
        server.decode(6)
    same_state(js, ps)
    assert ps.steps == 3 + 4 + 5 + 5 + 6
