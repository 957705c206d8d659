"""The port's VLM family (llava: the dense stack with precomputed frontend
embeddings before the text) against the JAX package, on the CPU.

Config: ``llava-next-34b-smoke`` (f32, 2 layers, d_model 64, 4/2 heads of
16, the swiglu MLP of 128, 8 frontend rows, vocab 512).  Weights:
``tests/torch_models.py``; the frontend embeddings are drawn with numpy
in f32, as the data pipeline makes them.

- ``forward``: the frontend rows are cast to the activations' dtype and
  put before the tokens, positions run over the whole sequence, and the
  frontend rows are cut before the unembedding: the loss within 1e-5 and
  the text logits within 1e-4 of their scale of the reference's plain
  path and Pallas kernels (``interpret``), as the dense forward in
  ``tests/test_torch_train.py`` (rope's ulp); the frontend moves the text
  logits;
- the gradients match the port's own in f64 within 1e-4 and ``jax.grad``
  within 2e-4 (``torch_models.check_grads``), with and without remat;
- the spec trees match the reference's (smoke and published widths);
- three train steps match the reference's ``jit_train_step`` on the
  reference's batches, frontend included;
- the server (text only: the reference's takes no frontend) gives the
  reference server's tokens, token for token, and ``serve_requests`` the
  same counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch.configs import registry as preg
from repro_torch.launch import serve as pserve
from repro_torch.models import lm as plm
from repro_torch.models import params as pparams
from torch_models import (
    assert_same_specs,
    auto_mesh,
    both_weights,
    check_grads,
    close_to_scale,
    configs,
    drive_servers,
    forward_both,
    get_path,
    jax_weights,
    leaves_with_paths,
    servers,
    to_torch,
    tokens_batch,
    train_steps_both,
)

ARCH = "llava-next-34b-smoke"


@pytest.mark.parametrize("smoke", [True, False])
def test_spec_trees_match_the_reference(smoke):
    cj, cp = jreg.get("llava-next-34b", smoke), preg.get("llava-next-34b", smoke)
    assert_same_specs(plm.lm_specs(cp), jlm.lm_specs(cj))
    assert_same_specs(plm.cache_specs(cp, 4, 512), jlm.cache_specs(cj, 4, 512))


@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_forward_matches_jax(backend):
    cj, cp = configs(ARCH)
    pj, pp = both_weights(cj, cp, seed=1)
    batch = tokens_batch(cj, 2, 56, seed=2)  # 8 frontend rows + 56 tokens: S 64
    assert batch["frontend"].shape == (2, 8, cj.d_model)
    (loss_j, logits_j), (loss_p, logits_p) = forward_both(cj, cp, pj, pp, batch, backend)
    assert logits_p.shape == logits_j.shape == (2, 56, 512)
    close_to_scale(logits_p, logits_j, 1e-4)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


def test_the_frontend_moves_the_text_logits():
    """The same tokens after other frontend rows give other text logits
    (the rows are attended to, not dropped), and a bf16 model takes the
    f32 frontend (cast to its dtype)."""
    cj, cp = configs(ARCH)
    _, pp = both_weights(cj, cp, seed=3)
    batch = tokens_batch(cj, 1, 24, seed=4)
    _, first = plm.forward(cp, pp, to_torch(batch))
    batch["frontend"] = batch["frontend"][:, ::-1].copy()
    _, second = plm.forward(cp, pp, to_torch(batch))
    assert float((first - second).abs().max()) > 1e-3
    cbf = dataclasses.replace(cp, param_dtype=torch.bfloat16)
    pbf = pparams.tree_map(lambda t: t.to(torch.bfloat16) if t.dim() > 1 else t, pp)
    loss_bf, logits_bf = plm.forward(cbf, pbf, to_torch(batch))
    loss, _ = plm.forward(cp, pp, to_torch(batch))
    assert logits_bf.dtype == torch.float32 and logits_bf.shape == first.shape
    assert bool(torch.isfinite(logits_bf).all())
    assert abs(float(loss_bf) - float(loss)) < 0.05


@pytest.mark.parametrize("remat", ["none", "full"])
def test_gradients_match_jax(remat):
    cj, cp = configs(ARCH, remat=remat)
    check_grads(cj, cp, jax_weights(cj, seed=5), tokens_batch(cj, 2, 56, seed=6))


def test_three_train_steps_match_jax():
    """The reference's token source makes the frontend rows (S 64 = 8 rows
    + 56 tokens): losses within 1e-5, grad norms within 1e-3, every
    parameter within 1e-5 of its scale (``tests/test_torch_train.py``)."""
    run = train_steps_both(ARCH)
    for _ in range(3):
        pm, jm = next(run)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    pp, jp = next(run)
    for path, want in leaves_with_paths(jp):
        close_to_scale(get_path(pp, path), want, 1e-5)


def test_batched_server_matches_the_jax_server():
    js, ps = servers(ARCH, batch=2, ctx=32)
    assert set(ps.cache) == set(js.cache) == {"k", "v"}
    drive_servers(js, ps, preg.get(ARCH).vocab)
    close_to_scale(ps.cache["k"], js.cache["k"], 1e-5)


def test_serve_requests_matches_the_jax_counts(monkeypatch):
    monkeypatch.setattr(jserve, "make_host_mesh", lambda **kw: auto_mesh())
    kw = dict(batch=2, ctx=24, n_requests=3, max_tokens=4, seed=0)
    want = jserve.serve_requests(ARCH, **kw)
    got = pserve.serve_requests(ARCH, device="cpu", **kw)
    assert (got["completed"], got["tokens"]) == (want["completed"], want["tokens"])
    assert got["completed"] == 3
