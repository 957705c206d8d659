"""The port's serving kernels against the Pallas kernels they replace.

On the CPU, ``ops.rmsnorm``/``ops.decode_attention`` run the plain PyTorch
versions (``repro_torch.kernels.ref``); they are held against
``repro.kernels.norms.rmsnorm`` and ``flash_attention.flash_decode`` in
Pallas interpret mode on the shape sweeps of ``tests/test_kernels.py``,
in f32 and bf16.  Tolerances: rmsnorm f32 rtol = atol = 1e-5 (the
reduction order differs), bf16 rtol 2e-2 / atol 1e-2 (the reference's);
flash_decode f32 1e-4 (the reference's), bf16 one bf16 step (both round
the same f32 value, rtol 2**-7).  The port's ``flash_decode`` is batched;
the Pallas one takes one sequence, so each batch row is held against its
own Pallas call.  The CUDA kernels themselves are held against these
plain versions in ``tests/test_torch_cuda.py`` (on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import norms as jnorms
from repro.kernels import ref as jref
from repro_torch.kernels import common as pcommon
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import norms as pnorms
from repro_torch.kernels import ops, ref

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RMS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}
DECODE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0**-7, 1e-6)}


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(TORCH_DTYPE[dtype])


def to_jax(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(dtype)


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 128), (16, 1024), (3, 1001), (2, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(shape, dtype):
    x = normal(len(shape), shape)
    w = normal(7, (shape[-1],), 0.5)
    want = jnorms.rmsnorm(to_jax(x, dtype), to_jax(w, dtype), interpret=True)
    got = ops.rmsnorm(to_torch(x, dtype), to_torch(w, dtype))
    assert str(got.dtype) == f"torch.{want.dtype}" and got.shape == want.shape
    rtol, atol = RMS_TOL[dtype]
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=rtol, atol=atol)


def test_rmsnorm_f32_weight_beside_bf16_input():
    """The serving path: a bf16 residual stream, f32 norm weights
    (``layers.norm_spec``); the output stays bf16."""
    x = normal(3, (4, 5120))
    w = 1.0 + normal(4, (5120,), 0.2)
    want = jnorms.rmsnorm(to_jax(x, "bfloat16"), jnp.asarray(w), interpret=True)
    got = pnorms.rmsnorm(to_torch(x, "bfloat16"), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-2, atol=1e-2)


def test_rmsnorm_plain_version_matches_the_jax_reference():
    x = normal(5, (6, 96))
    w = normal(6, (96,))
    got = ref.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5)
    want = jref.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------


def _pallas_rows(q, k, v, kv_len, dtype):
    """The Pallas kernel on each batch row of the port's batched inputs."""
    rows = [
        jfa.flash_decode(
            to_jax(q[b], dtype),
            to_jax(k[b], dtype),
            to_jax(v[b], dtype),
            int(kv_len[b]),
            bk=128,
            interpret=True,
        )
        for b in range(q.shape[0])
    ]
    return np.stack([as_f32(r) for r in rows])


def _port(q, k, v, kv_len, dtype):
    return ops.decode_attention(
        to_torch(q, dtype),
        to_torch(k, dtype),
        to_torch(v, dtype),
        torch.tensor(kv_len, dtype=torch.int32),
    )


@pytest.mark.parametrize(
    "S,H,Hkv,D,kv_len",
    [
        (512, 8, 2, 64, [300]),
        (256, 4, 1, 64, [256]),
        (512, 4, 4, 128, [17]),
        (256, 8, 2, 64, [1, 129, 256]),  # ragged per-row lengths
        (128, 10, 2, 16, [128, 40]),  # g = 5, as qwen2.5-14b
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_pallas(S, H, Hkv, D, kv_len, dtype):
    B = len(kv_len)
    q = normal(1, (B, H, D), 0.5)
    k = normal(2, (B, S, Hkv, D), 0.5)
    v = normal(3, (B, S, Hkv, D), 0.5)
    want = _pallas_rows(q, k, v, kv_len, dtype)
    got = _port(q, k, v, kv_len, dtype)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (B, H, D)
    rtol, atol = DECODE_TOL[dtype]
    np.testing.assert_allclose(as_f32(got), want, rtol=rtol, atol=atol)


def test_flash_decode_kv_len_past_the_cache_means_all_valid():
    """``kv_len > S`` (a slot stepped past its context) attends to every
    position, as the Pallas kernel does."""
    S, H, Hkv, D = 256, 4, 2, 64
    q = normal(4, (2, H, D), 0.5)
    k = normal(5, (2, S, Hkv, D), 0.5)
    v = normal(6, (2, S, Hkv, D), 0.5)
    over = _port(q, k, v, [S + 1, 3 * S], "float32")
    full = _port(q, k, v, [S, S], "float32")
    assert torch.equal(over, full)
    want = _pallas_rows(q, k, v, [S + 1, 3 * S], "float32")
    np.testing.assert_allclose(over.numpy(), want, rtol=1e-4, atol=1e-4)


def test_flash_decode_kv_len_zero_returns_zeros_as_the_kernel_does():
    """With no valid position the Pallas kernel keeps lsum = 0 -> 1 and
    returns zeros; the JAX package's plain version returns the mean of V
    instead.  The port follows the kernel (serving never gets there:
    kv_len >= 1)."""
    S, H, Hkv, D = 128, 4, 2, 64
    q = normal(7, (1, H, D), 0.5)
    k = normal(8, (1, S, Hkv, D), 0.5)
    v = normal(9, (1, S, Hkv, D), 0.5)
    got = _port(q, k, v, [0], "float32")
    kernel = _pallas_rows(q, k, v, [0], "float32")
    plain = np.asarray(jref.decode_attention(q[0], k[0], v[0], 0))
    assert not got.any() and not kernel.any()
    np.testing.assert_allclose(plain, np.repeat(v[0].mean(0), H // Hkv, 0), atol=1e-5)


def test_flash_decode_takes_a_strided_cache():
    """A layer of the stacked (L, B, S, Hkv, D) cache, and a cache whose
    batch axis is strided, give the same result as a contiguous copy."""
    L, B, S, Hkv, D, H = 3, 2, 64, 2, 32, 4
    kc = torch.from_numpy(normal(10, (L, 2 * B, S, Hkv, D)))
    vc = torch.from_numpy(normal(11, (L, 2 * B, S, Hkv, D)))
    q = torch.from_numpy(normal(12, (B, H, D)))
    kv_len = torch.tensor([5, 64], dtype=torch.int32)
    k, v = kc[1, ::2], vc[1, ::2]
    assert not k.is_contiguous()
    got = pfa.flash_decode(q, k, v, kv_len)
    want = pfa.flash_decode(q, k.contiguous(), v.contiguous(), kv_len)
    assert torch.equal(got, want)


def test_split_count_fills_the_card(monkeypatch):
    """Under one wave of resident blocks (2 an SM), ranges of at least 64
    rows; above it, the fewest splits whose last wave is 90 % full; at
    most 64 splits."""
    monkeypatch.setitem(pcommon._SM_COUNT, 0, 132)  # the SM-count cache
    dev = torch.device("cuda", 0)
    assert pfa.num_splits(8, 8, 5, 32768, dev) == 4  # 64 units -> 256 of 264 slots
    assert pfa.num_splits(4, 8, 5, 512, dev) == 8  # the serve shape: 64 rows each
    assert pfa.num_splits(4, 1, 48, 512, dev) == 8  # MQA serve: 6 groups of 8 heads
    assert pfa.num_splits(1, 1, 1, 100000, dev) == 64
    assert pfa.num_splits(64, 8, 5, 4096, dev) == 1  # 512 blocks: 2 waves, 97 %
    assert pfa.num_splits(128, 8, 5, 4096, dev) == 1
    assert pfa.num_splits(2, 2, 1, 20, dev) == 1


@pytest.mark.parametrize("batch,n_kv,group,seq_len", [
    (8, 8, 5, 32768), (4, 8, 5, 512), (4, 1, 48, 512), (2, 1, 48, 2048), (1, 8, 5, 4096),
    (32, 8, 5, 8192), (16, 4, 7, 1000), (3, 2, 1, 70000), (200, 8, 5, 512),
])
@pytest.mark.parametrize("sms", [132, 114])
def test_split_grid_fills_its_waves(monkeypatch, batch, n_kv, group, seq_len, sms):
    """Every choice either stays under one wave with ranges of at least
    SPLIT_ROWS rows, or fills the grid's last wave to WAVE_FILL (or has
    no split count left that would)."""
    monkeypatch.setitem(pcommon._SM_COUNT, 0, sms)
    dev = torch.device("cuda", 0)
    heads = pfa.head_group(group)
    n = pfa.num_splits(batch, n_kv, group, seq_len, dev)
    most = max(1, min(pfa.MAX_SPLITS, -(-seq_len // pfa.SPLIT_ROWS)))
    assert 1 <= n <= most
    units = batch * n_kv * (group // heads)
    blocks = units * n
    slots = pfa.BLOCKS_PER_SM * sms
    if units * most <= slots:
        assert n == most
    else:
        waves = -(-blocks // slots)
        assert blocks >= pfa.WAVE_FILL * waves * slots or n == most


def test_head_groups_divide_the_group():
    """A block serves the largest divisor of g up to 8 heads: qwen2.5-14b's
    5, granite-20b's 48 in six blocks of 8, a prime group one head each."""
    assert [pfa.head_group(g) for g in (1, 5, 7, 8, 9, 40, 48, 11)] == [1, 5, 7, 8, 3, 8, 8, 1]
    for g in range(1, 65):
        heads = pfa.head_group(g)
        assert g % heads == 0 and heads <= pfa.MAX_GROUP
        assert not any(g % d == 0 for d in range(heads + 1, pfa.MAX_GROUP + 1))


def test_norm_plan_at_the_paths_shapes(monkeypatch):
    """The norm forward's launch: a warp per 768 columns (at most 8), as
    many rows a block as 256 threads hold, four rows a team.  Headlines
    (granite-20b, qwen2.5-14b, mamba2-130m) and the serving shapes (the
    decode batch of 4: a block a row)."""
    monkeypatch.setitem(pcommon._SM_COUNT, 0, 132)
    dev = torch.device("cuda", 0)
    assert pnorms.norm_plan(8192, 6144, dev) == (8, 1, 2048)
    assert pnorms.norm_plan(8192, 5120, dev) == (7, 1, 2048)
    assert pnorms.norm_plan(32768, 1536, dev) == (2, 4, 2048)
    assert pnorms.norm_plan(4, 6144, dev) == (8, 1, 4)
    assert pnorms.norm_plan(4, 5120, dev) == (7, 1, 4)
    assert pnorms.norm_plan(4, 768, dev) == (1, 8, 1)
    assert pnorms.norm_plan(4, 1536, dev) == (2, 4, 1)
    assert pnorms.norm_plan(600, 64, dev) == (1, 8, 75)


@pytest.mark.parametrize("cols", [1, 64, 768, 769, 1536, 5120, 6144, 6152, 20000])
@pytest.mark.parametrize("rows", [1, 7, 1000, 4096, 100000])
def test_norm_plan_covers_every_row(monkeypatch, rows, cols):
    """Every row has a team and no team walks more than NORM_ROWS rows, a
    team walks one row where the rows do not fill the SMs, a block stays
    within 256 threads, and a row of up to 6,144 columns fits its team's
    registers."""
    sms = 132
    monkeypatch.setitem(pcommon._SM_COUNT, 0, sms)
    warps, teams, blocks = pnorms.norm_plan(rows, cols, torch.device("cuda", 0))
    assert 1 <= warps <= pnorms.NORM_MAX_WARPS and teams * warps * 32 <= pnorms.NORM_BLOCK
    walk = -(-rows // (blocks * teams))  # rows the busiest team walks
    assert 1 <= walk <= pnorms.NORM_ROWS and (blocks - 1) * teams < rows
    if rows <= teams * sms:
        assert walk == 1
    if cols <= pnorms.NORM_MAX_WARPS * 32 * pnorms.NORM_HELD:
        assert warps * 32 * pnorms.NORM_HELD >= cols
