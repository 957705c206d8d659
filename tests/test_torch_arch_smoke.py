"""The per-architecture smoke tests of ``tests/test_arch_smoke.py`` in the
port, held against the JAX package on the CPU.

Every registered architecture at its smoke twin (f32, vocabulary 512,
``configs/base.py`` ``reduced``), the same numpy weights carried into
both packages (``torch_models.both_weights``: the constant inits
randomised; the encoder-decoder's and the hybrid's ``wq``/``wk`` at a
fan-in of d_model, ROADMAP C.4):

- forward (:36), B 2 x S 32 with the reference's batch (frontend rows
  for the VLM and the encoder-decoder): the reference's assertions on
  the port's loss and logits, and parity with the reference's
  ``forward(backend="xla")`` -- logits within 1e-4 of their largest
  magnitude, the loss within 1e-5 relative (``check_forward_and_decode``'s
  tolerances);
- one decode step (:60), B 2 over a cache of 64 rows, tokens 0 at
  positions 3 and 7, on a stale random cache: the port's new cache keeps
  the input's keys and shapes, and its logits are within 1e-5 of the
  reference ``decode_step``'s scale;
- greedy decode against the teacher-forced forward (:92 dense, :116 SSM)
  in the port, at the reference's rtol = atol = 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch.configs import registry as preg
from repro_torch.models import carry
from repro_torch.models import encdec as pencdec
from repro_torch.models import lm as plm
from repro_torch.models.params import init_params
from torch_models import as_jax, both_weights, close_to_scale, forward_both

ARCHS = jreg.names()


def smoke_configs(arch):
    return jreg.get(arch, smoke=True), preg.get(arch, smoke=True)


def make_batch(cfg, B=2, S=32):
    """The reference's batch (``test_arch_smoke.make_batch``), as numpy."""
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        return {
            "frontend": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        }
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
    }
    if cfg.n_frontend_tokens:
        batch["frontend"] = rng.normal(size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def weights(cj, cp, seed):
    return both_weights(cj, cp, seed=seed, model_fan_in=cj.family in ("encdec", "hybrid"))


def test_every_architecture_is_covered():
    assert ARCHS == preg.names() and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_smoke(arch):
    cj, cp = smoke_configs(arch)
    B, S = 2, 32
    pj, pp = weights(cj, cp, seed=0)
    batch = make_batch(cj, B, S)
    (loss_j, logits_j), (loss, logits) = forward_both(cj, cp, pj, pp, batch, "xla")
    assert logits.shape[:2] == (B, S)
    assert logits.shape[-1] >= cp.vocab
    assert np.isfinite(float(loss)), f"loss not finite: {loss}"
    assert torch.isfinite(logits.float()).all()
    # sane CE at init: close to log(vocab)
    assert float(loss) < np.log(cp.vocab) + 2.0
    assert logits.shape == tuple(logits_j.shape)
    close_to_scale(logits, logits_j, 1e-4)
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


def _caches(cj, cp, B, S, seed):
    """A stale cache drawn with numpy: ``(JAX cache, port cache)``."""
    if cj.family == "encdec":
        specs = jencdec.cache_specs(cj, B, S, enc_len=16)
    else:
        specs = jlm.cache_specs(cj, B, S)
    rng = np.random.default_rng(seed)
    tree = {k: (0.5 * rng.normal(size=s.shape)).astype(np.float32) for k, s in specs.items()}
    return as_jax(tree), carry.cache_from_numpy(cp, tree, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_smoke(arch):
    cj, cp = smoke_configs(arch)
    B, S = 2, 64
    pj, pp = weights(cj, cp, seed=1)
    cache_j, cache_p = _caches(cj, cp, B, S, seed=2)
    shapes = {k: tuple(v.shape) for k, v in cache_p.items()}
    tokens = np.zeros((B,), np.int32)
    pos = np.array([3, 7], np.int32)
    jmod, pmod = (jencdec, pencdec) if cj.family == "encdec" else (jlm, plm)
    want, _ = jmod.decode_step(cj, pj, cache_j, jnp.asarray(tokens), jnp.asarray(pos), backend="xla")
    logits, new_cache = pmod.decode_step(cp, pp, cache_p, torch.from_numpy(tokens), torch.from_numpy(pos))
    assert logits.shape[0] == B
    assert torch.isfinite(logits.float()).all()
    # cache structure preserved
    assert {k: tuple(v.shape) for k, v in new_cache.items()} == shapes
    close_to_scale(logits, want, 1e-5)


@pytest.mark.parametrize("arch,seed", [("qwen2.5-14b", 3), ("mamba2-130m", 4)], ids=["dense", "ssm"])
def test_decode_matches_forward(arch, seed):
    """Greedy decode logits must match teacher-forced forward logits."""
    cfg = preg.get(arch, smoke=True)
    B, S = 1, 8
    params = init_params(plm.lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    _, full_logits = plm.forward(cfg, params, {"tokens": tokens, "labels": tokens})
    cache = init_params(plm.cache_specs(cfg, B, S), None, "cpu")
    outs = []
    for t in range(S):
        logits, cache = plm.decode_step(cfg, params, cache, tokens[:, t], torch.full((B,), t, dtype=torch.int32))
        outs.append(logits)
    dec_logits = torch.stack(outs, dim=1)
    np.testing.assert_allclose(
        dec_logits.float().numpy(), full_logits.float().numpy(), rtol=2e-2, atol=2e-2
    )
