"""The port on a CUDA card, against the port on the CPU.

Every runnable kernel of ``benchmarks/kernels_suite.py`` (parsed by the
port: a copy whose ``cox`` import points at ``repro_torch.core``) is
launched on CUDA tensors and on CPU tensors with the same inputs; the
two must agree bitwise, which holds the CUDA-side torch semantics
(scatters, atomics, integer division, casts) to the CPU's, and so to the
JAX package's (``tests/test_torch_launch.py``).  This file imports no
JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Every test carries the ``cuda`` marker and skips where there is no card.
"""

import dataclasses
import importlib.util
import pathlib
import sys
import tempfile

import pytest
import torch

from repro_torch.core import cox, execute
from repro_torch.kernels import adamw as padamw
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import norms as pnorms
from repro_torch.kernels import ops, ref
from repro_torch.kernels import softmax as psm
from repro_torch.kernels import ssd_scan as pssd
from repro_torch.optim import adamw as poptim

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_IMPORT = "from repro.core import cox"


def _load_port_suite():
    """The kernels suite, parsed by the port (the kernels keep their
    parsed source, so the file is gone once the module has run)."""
    src = (ROOT / "benchmarks" / "kernels_suite.py").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "port_kernels_suite_cuda.py"
        path.write_text(src.replace(REF_IMPORT, "from repro_torch.core import cox"))
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return mod


SUITE = {k.name: k for k in _load_port_suite().all_kernels() if k.kernel is not None}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(SUITE))
def test_suite_on_cuda_matches_cpu(cuda, name):
    sk = SUITE[name]
    args = sk.make_args()
    want = sk.kernel.launch(grid=sk.grid, block=sk.block, args=args, device="cpu")
    got = sk.kernel.launch(grid=sk.grid, block=sk.block, args=args)
    for k, w in want.items():
        assert got[k].device.type == "cuda"
        assert got[k].dtype == w.dtype
        assert torch.equal(got[k].cpu(), w), f"{name}.{k}"


@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
@pytest.mark.parametrize(
    "name,knobs",
    [
        ("MatrixMulCUDA", {"chunk": 3}),
        ("MatrixMulCUDA", {"chunk": 16}),
        ("reduce4", {"chunk": 3}),
        ("histogram64", {"chunk": 5}),
        ("gridReduce", {}),
        ("gridReduce", {"n_resident": 3}),
    ],
)
def test_vmap_on_cuda_matches_scan(cuda, name, knobs, warp_exec):
    """The block-parallel backend and the batched warp plane on the card,
    bitwise the serial scan launch on the card; the outputs stay there."""
    sk = SUITE[name]
    args = sk.make_args()
    kw = dict(grid=sk.grid, block=sk.block, args=args)
    want = sk.kernel.launch(backend="scan", warp_exec="serial", **kw)
    got = sk.kernel.launch(backend="vmap", warp_exec=warp_exec, **knobs, **kw)
    for k, w in want.items():
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], w), f"{name}.{k}"


@cox.kernel
def _bid_trips(c, out: cox.Array(cox.f32), a: cox.Array(cox.f32)):
    # a block-level loop whose trip count is the block id: the blocks of
    # a wave leave it at different peels
    tile = c.shared((64,), cox.f32)
    tid = c.thread_idx()
    i = c.block_idx() * c.block_dim() + tid
    acc = a[i]
    t = 0
    while t < c.block_idx():
        tile[tid] = acc
        c.syncthreads()
        acc = acc + tile[(tid + 1) % 64]
        c.syncthreads()
        t = t + 1
    out[i] = acc


@pytest.mark.parametrize("warp_exec", ["serial", "batched"])
def test_vmap_divergent_blocks_on_cuda(cuda, warp_exec):
    a = torch.randint(-4, 5, (7 * 64,), device=cuda).float()
    kw = dict(grid=7, block=64, args=(torch.zeros_like(a), a), collapse="hier")
    want = _bid_trips.launch(backend="scan", warp_exec="serial", **kw)["out"]
    before = execute.host_syncs
    got = _bid_trips.launch(backend="vmap", warp_exec=warp_exec, **kw)["out"]
    assert execute.host_syncs - before == 7  # one flag vector a trip
    assert torch.equal(got, want)
    cpu = _bid_trips.launch(device="cpu", backend="scan", **{**kw, "args": (a.cpu() * 0, a.cpu())})
    assert torch.equal(got.cpu(), cpu["out"])


@cox.kernel
def _scale(c, out: cox.Array(cox.f32), a: cox.Array(cox.f32), n: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i] * 2.0


def test_launch_runs_on_the_card_by_default(cuda):
    a = torch.arange(100, dtype=torch.float32, device=cuda)
    out = _scale.launch(grid=4, block=32, args=(torch.zeros_like(a), a, 100))["out"]
    assert out.device.type == "cuda"
    assert torch.equal(out, a * 2)
    with pytest.raises(ValueError, match="move it"):
        _scale.launch(grid=4, block=32, args=(torch.zeros(100), a, 100))


@cox.kernel
def _row_max(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), cols: cox.i32):
    row = c.block_idx() * (c.block_dim() // 32) + c.warp_id()
    m = -1e30
    j = c.lane_id()
    while j < cols:
        m = max(m, x[row * cols + j])
        j = j + 32
    m = c.red_max(m)
    if c.lane_id() == 0:
        out[row] = m


def test_cox_row_max_equals_the_kernel_and_counts_flag_reads(cuda):
    x = torch.randn(4, 300, device=cuda)
    before = execute.host_syncs
    got = _row_max.launch(grid=2, block=64, args=(x.new_zeros(4), x, 300))["out"]
    # one any-lane read per trip: 10 trips (ceil(300 / 32)) + the exit, per warp
    assert execute.host_syncs - before == 4 * 11
    assert torch.equal(got, ops.row_reduce(x, "max"))
    assert torch.equal(got, ref.row_reduce(x, "max"))


@cox.kernel
def _scatter_add(
    c,
    out: cox.Array(cox.f32),
    hits: cox.Array(cox.i32),
    idx: cox.Array(cox.i32),
    val: cox.Array(cox.f32),
    n: cox.i32,
):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(out, idx[i], val[i])
        c.atomic_add(hits, idx[i], 1)


def test_float_atomics_within_tolerance(cuda):
    """Float atomic sums on CUDA run in the device's order: within
    rtol = atol = 1e-5 of the CPU's; integer atomics are exact."""
    gen = torch.Generator().manual_seed(0)
    n = 4096
    idx = torch.randint(0, 37, (n,), generator=gen, dtype=torch.int32)
    val = torch.randn(n, generator=gen)
    args = (torch.zeros(37), torch.zeros(37, dtype=torch.int32), idx, val, n)
    want = _scatter_add.launch(grid=16, block=256, args=args, device="cpu")
    on_card = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    got = _scatter_add.launch(grid=16, block=256, args=on_card)
    torch.testing.assert_close(got["out"].cpu(), want["out"], rtol=1e-5, atol=1e-5)
    assert torch.equal(got["hits"].cpu(), want["hits"])


# Softmax outputs are compared entry by entry (relative): a fixed atol
# would cover most entries of a wide row, whose mean is 1/cols.  float16
# keeps one subnormal step, where the two may round apart.
SOFTMAX_TOL = {
    torch.float32: (1e-5, 0.0),
    torch.bfloat16: (2e-2, 0.0),
    torch.float16: (2e-2, 2.0**-24),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kernels_take_every_dtype(cuda, dtype):
    x = (torch.randn(3, 1027, device=cuda) * 3).to(dtype)
    ops.reset_launch_counts()
    rtol, atol = SOFTMAX_TOL[dtype]
    torch.testing.assert_close(
        ops.softmax(x).float(), ref.softmax(x).float(), rtol=rtol, atol=atol
    )
    for op in ("max", "absmax"):
        assert torch.equal(ops.row_reduce(x, op), ref.row_reduce(x, op))
    assert ops.launch_counts() == {
        "softmax": 1,
        "row_reduce": 2,
        "rmsnorm": 0,
        "rmsnorm_bwd": 0,
        "layernorm": 0,
        "layernorm_bwd": 0,
        "flash_decode": 0,
        "flash_attention": 0,
        "flash_attention_bwd": 0,
        "ssd_scan": 0,
        "ssd_scan_bwd": 0,
        "adamw_sumsq": 0,
        "adamw_apply": 0,
    }


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        ops.softmax(torch.zeros(4, 8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.softmax(torch.zeros(8, 4, device=cuda).t())
    with pytest.raises(ValueError, match="rows, cols"):
        ops.row_reduce(torch.zeros(2, 3, 4, device=cuda))


def test_nan_propagates_through_the_kernels(cuda):
    x = torch.randn(3, 777, device=cuda)
    x[1, 500] = float("nan")
    assert torch.isnan(ops.row_reduce(x, "max")[1])
    assert torch.isnan(ops.softmax(x)[1]).all()
    assert not torch.isnan(ops.softmax(x)[0]).any()


def test_all_minus_inf_prefix_rows(cuda):
    """A row whose first elements are -inf (masked logits) stays finite."""
    x = torch.randn(2, 5000, device=cuda)
    x[:, :4000] = float("-inf")
    torch.testing.assert_close(ops.softmax(x), ref.softmax(x), rtol=1e-5, atol=0.0)


def test_ragged_vocabulary_widths(cuda):
    for cols in (1, 31, 32769, 152064 + 3):
        x = torch.randn(2, cols, device=cuda)
        torch.testing.assert_close(ops.softmax(x), ref.softmax(x), rtol=1e-5, atol=0.0)
        torch.testing.assert_close(
            ops.row_reduce(x, "sum"), ref.row_reduce(x, "sum"), rtol=1e-5, atol=1e-4
        )
    # an unaligned view: rows start off a 16-byte boundary
    base = torch.randn(3 * 1001 + 1, device=cuda)
    x = base[1:].view(3, 1001)
    torch.testing.assert_close(ops.softmax(x), ref.softmax(x), rtol=1e-5, atol=0.0)
    assert torch.equal(ops.row_reduce(x, "max"), ref.row_reduce(x, "max"))


# ---------------------------------------------------------------------------
# softmax's three regimes (kernels/softmax.py softmax_plan)
# ---------------------------------------------------------------------------

VOCAB = 152064


def _long_cols(itemsize: int) -> int:
    """The narrowest row that takes the long regime: its slice at
    MAX_CLUSTER blocks outgrows one stage of shared memory."""
    n = 16 // itemsize
    return n * (psm.MAX_CLUSTER * ((psm.MAX_SMEM - psm.STATIC_SMEM) // 16) + 1)


def _softmax_case(x, dtype, regime=None):
    """One call, held to the plain version at SOFTMAX_TOL; one launch;
    bitwise equal to a second call; the plan's regime where one is named."""
    plan = psm.softmax_plan(x.numel() // x.shape[-1], x.shape[-1], x.dtype, x.device)
    if regime is not None:
        assert plan.regime == regime, plan
    before = psm.launches
    got = ops.softmax(x)
    assert psm.launches == before + 1
    assert got.data_ptr() % 16 == x.data_ptr() % 16 and got.is_contiguous()
    rtol, atol = SOFTMAX_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.softmax(x).float(), rtol=rtol, atol=atol)
    assert torch.equal(got, ops.softmax(x)), "not bitwise equal over two calls"
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "rows, cols, regime",
    [
        (33, psm.ROW_MAX_COLS, "rows"),
        (33, psm.ROW_MAX_COLS + 1, "cluster"),
        (3, 4096, "rows"),
        (4096, 4096, "rows"),
        (64, VOCAB, "cluster"),
        (2, VOCAB, "cluster"),
        (5, 32769, "cluster"),
    ],
)
def test_softmax_regimes_and_their_boundaries(cuda, dtype, rows, cols, regime):
    """Each regime, and the widths on both sides of the rows/cluster
    boundary, against the plain version; bitwise twice; one launch."""
    gen = torch.Generator(device=cuda).manual_seed(rows + cols)
    x = (3 * torch.randn(rows, cols, generator=gen, device=cuda)).to(dtype)
    _softmax_case(x, dtype, regime)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_cluster_long_boundary(cuda, dtype):
    """The widest rows a cluster holds in shared memory, and one vector
    wider: the long regime, which reads x twice."""
    size = torch.tensor([], dtype=dtype).element_size()
    first = _long_cols(size)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for cols, regime in ((first - 1, "cluster"), (first, "long")):
        x = (3 * torch.randn(2, cols, generator=gen, device=cuda)).to(dtype)
        _softmax_case(x, dtype, regime)


def test_softmax_long_rows(cuda):
    """2 x 2^20 f32 (4 MB a row) in the long regime."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = 3 * torch.randn(2, 2**20, generator=gen, device=cuda)
    _softmax_case(x, torch.float32, "long")


@pytest.mark.parametrize("cols", [1001, 8191, VOCAB + 3, _long_cols(4) + 1])
def test_softmax_odd_widths_start_rows_unaligned(cuda, cols):
    """Odd widths put every other row off the 16-byte boundary, and an
    offset view every row: the rows keep their vectors, the head and tail
    go through plain loads; y shares x's offset modulo 16 bytes."""
    gen = torch.Generator(device=cuda).manual_seed(cols)
    x = 3 * torch.randn(4, cols, generator=gen, device=cuda)
    _softmax_case(x, torch.float32)
    base = 3 * torch.randn(3 * cols + 8, generator=gen, device=cuda)
    for off in (1, 2, 3):
        _softmax_case(base[off : off + 3 * cols].view(3, cols), torch.float32)
    xb = x.to(torch.bfloat16)
    _softmax_case(xb, torch.bfloat16)
    _softmax_case(base.to(torch.bfloat16)[5 : 5 + 3 * cols].view(3, cols), torch.bfloat16)


@pytest.mark.parametrize("cols", [VOCAB, _long_cols(4)])
def test_softmax_a_slice_all_minus_inf(cuda, cols):
    """A block whose whole slice is -inf adds 0 to the row's sum, in every
    block's place; its outputs are 0."""
    x = 3 * torch.randn(2, cols, device=cuda)
    plan = psm.softmax_plan(2, cols, x.dtype, x.device)
    assert plan.regime in ("cluster", "long")
    per = -(-(cols // 4) // plan.cluster)
    for rank in (0, plan.cluster // 2, plan.cluster - 1):
        xm = x.clone()
        xm[0, 4 * rank * per : 4 * (rank + 1) * per] = float("-inf")
        got = _softmax_case(xm, torch.float32)
        assert (got[0, 4 * rank * per : 4 * (rank + 1) * per] == 0).all()


@pytest.mark.parametrize("cols", [4096, VOCAB, _long_cols(4)])
def test_softmax_nan_in_the_last_slice(cuda, cols):
    """A NaN in the last block's slice (the last columns) makes its whole
    row NaN and no other; a row all -inf gives the plain version's NaN."""
    x = 3 * torch.randn(3, cols, device=cuda)
    x[1, cols - 3] = float("nan")
    x[2] = float("-inf")
    got = ops.softmax(x)
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()
    assert torch.isnan(ref.softmax(x)[2]).all()
    torch.testing.assert_close(got[0], ref.softmax(x)[0], rtol=1e-5, atol=0.0)


def test_softmax_f16_at_vocabulary_width(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = (3 * torch.randn(64, VOCAB, generator=gen, device=cuda)).half()
    _softmax_case(x, torch.float16, "cluster")
    _softmax_case(x[:2].contiguous(), torch.float16, "cluster")


def test_softmax_stages_give_the_same_bits(cuda):
    """One stage or two (the next row's slice in flight or not): the same
    sums in the same order, so the same bits, each within SOFTMAX_TOL."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = 3 * torch.randn(64, VOCAB, generator=gen, device=cuda)
    base = psm.softmax_plan(64, VOCAB, x.dtype, x.device)
    assert base.regime == "cluster"
    code = build.DTYPE_CODES[x.dtype]
    outs = []
    for stages in (1, 2):
        smem = 16 * stages * base.slice
        fit = psm._clusters_that_fit(x.device.index, code, "cluster", base.cluster, smem)
        plan = dataclasses.replace(base, stages=stages, smem=smem, clusters=min(64, fit))
        before = psm.launches
        with torch.cuda.device(x.device):
            got = psm._launch(x, plan)
        assert psm.launches == before + 1
        rtol, atol = SOFTMAX_TOL[torch.float32]
        torch.testing.assert_close(got, ref.softmax(x), rtol=rtol, atol=atol)
        outs.append(got)
    assert torch.equal(outs[0], outs[1])


def test_row_sum_is_accurate_at_vocabulary_width(cuda):
    """400 seeded rows of 152,067 N(0, 1) values (the vocabulary and a
    ragged tail): each row's kernel sum within the row sum's tolerance
    (rtol 1e-5, atol 1e-4) of its f64 sum."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(400, 152064 + 3, generator=gen, device=cuda)
    got = ops.row_reduce(x, "sum")
    want = x.double().sum(dim=-1)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the serving kernels: rmsnorm and flash_decode against their plain versions
# ---------------------------------------------------------------------------

# rmsnorm: f32 1e-5 (the sum's order differs); bf16/f16 rtol 2e-2 and
# atol 1e-2, the reference's (tests/test_kernels.py)
RMS_TOL = {
    torch.float32: (1e-5, 1e-5),
    torch.bfloat16: (2e-2, 1e-2),
    torch.float16: (2e-2, 1e-2),
}
# flash_decode: f32 1e-4 (the reference's); in bf16, both versions
# round the same f32 value, so at most one step apart
DECODE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0**-7, 1e-6)}


@pytest.mark.parametrize(
    "shape",
    [
        (8, 128),
        (16, 1024),
        (4, 5120),
        (3, 1001),
        (2, 3, 6000),
        (1, 20000),
        (4, 768),
        (4, 1536),
        # the forward's edges: a warp's register budget (768 columns) and
        # one vector past it; eight warps' (6,144) and one vector past it
        # in f32 (6,148) and in bf16 (6,152); rows that are not a multiple
        # of the teams a block, and enough rows for each team to walk
        # several (prefetching the next)
        (2, 776),
        (2, 772),
        (3, 6144),
        (3, 6148),
        (3, 6152),
        (37, 5120),
        (5000, 768),
        (4000, 1536),
        (900, 6144),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("wdtype", [torch.float32, "same"])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, wdtype):
    wdtype = dtype if wdtype == "same" else wdtype
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (1 + 0.3 * torch.randn(shape[-1], generator=gen, device=cuda)).to(wdtype)
    before = ops.launch_counts()["rmsnorm"]
    got = ops.rmsnorm(x, w)
    assert ops.launch_counts()["rmsnorm"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    rtol, atol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, w).float(), rtol=rtol, atol=atol)


def test_rmsnorm_rows_off_a_16_byte_boundary(cuda):
    base = torch.randn(3 * 1001 + 1, device=cuda)
    x = base[1:].view(3, 1001)  # rows start unaligned
    w = torch.randn(1001, device=cuda)
    torch.testing.assert_close(ops.rmsnorm(x, w), ref.rmsnorm(x, w), rtol=1e-5, atol=1e-5)
    xb = torch.randn(4 * 5120 + 1, device=cuda).to(torch.bfloat16)[1:].view(4, 5120)
    wb = torch.randn(5120, device=cuda)
    torch.testing.assert_close(
        ops.rmsnorm(xb, wb).float(), ref.rmsnorm(xb, wb).float(), rtol=2e-2, atol=1e-2
    )


def test_norms_take_weights_off_a_16_byte_boundary(cuda):
    """w and b that start off a 16-byte boundary are staged with scalar
    loads; the rows themselves stay on the vector path."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for cols in (1536, 6144):
        x = torch.randn(64, cols, generator=gen, device=cuda).to(torch.bfloat16)
        w = (1 + 0.3 * torch.randn(cols + 1, generator=gen, device=cuda))[1:]
        b = (0.3 * torch.randn(cols + 1, generator=gen, device=cuda))[1:]
        assert w.data_ptr() % 16 and b.data_ptr() % 16
        torch.testing.assert_close(
            ops.rmsnorm(x, w).float(), ref.rmsnorm(x, w).float(), rtol=2e-2, atol=1e-2
        )
        torch.testing.assert_close(
            ops.layernorm(x, w, b).float(), ref.layernorm(x, w, b).float(), rtol=2e-2, atol=1e-2
        )


def _decode_inputs(cuda, B, S, H, Hkv, D, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, H, D, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=cuda).to(dtype)
    return q, k, v


@pytest.mark.parametrize(
    "B,S,H,Hkv,D,kv_len",
    [
        (4, 512, 40, 8, 128, [9, 100, 511, 512]),  # the serving shape, g = 5
        (2, 1000, 8, 2, 64, [1, 1000]),  # S not a multiple of the tile
        (3, 256, 4, 1, 64, [0, 300, 17]),  # kv_len 0 and past S
        (1, 128, 40, 1, 128, [128]),  # g = 40
        # granite-20b's MQA at the serving shape: 48 query heads over 1, g = 48
        pytest.param(4, 512, 48, 1, 128, [9, 100, 511, 512], id="mqa-serve"),
        (2, 64, 4, 4, 64, [64, 33]),  # g = 1
        (2, 96, 4, 2, 128, [5, 96]),
        (1, 200, 8, 4, 128, [150]),
        # the new design's edges: S shorter than one tile (8 rows in bf16
        # at D = 128, 16 at D = 64; 4 and 8 in f32)
        (2, 5, 10, 2, 128, [5, 3]),
        (2, 3, 8, 2, 64, [3, 2]),
        # kv_len ending mid-tile, mid-stage (a warp with fewer tiles than
        # its ring) and mid-split, over many splits
        (3, 4096, 40, 8, 128, [13, 1000, 4093]),
        (2, 4096, 40, 8, 64, [4089, 70]),
        # g = 40 and 48 at D = 64 (groups of 8 heads), g = 9 (three of 3),
        # g = 7 (one of 7), beside g = 1 and 5 above
        (2, 777, 48, 1, 64, [777, 400]),
        (2, 300, 40, 1, 64, [300, 299]),
        (1, 300, 9, 1, 128, [300]),
        (2, 2048, 56, 8, 128, [2047, 1500]),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, B, S, H, Hkv, D, kv_len, dtype):
    q, k, v = _decode_inputs(cuda, B, S, H, Hkv, D, dtype)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["flash_decode"]
    got = ops.decode_attention(q, k, v, lens)
    assert ops.launch_counts()["flash_decode"] == before + 1
    want = ref.decode_attention(q, k, v, lens)
    assert got.dtype == dtype and got.shape == (B, H, D)
    rtol, atol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if 0 in kv_len:
        assert not got[kv_len.index(0)].any()


def test_flash_decode_long_ragged_batch_is_deterministic(cuda):
    """The long-context headline (B 8, S 32,768, 40/8, bf16) with ragged
    lengths, against the plain version; two calls give the same bits."""
    B, S, H, Hkv, D = 8, 32768, 40, 8, 128
    q, k, v = _decode_inputs(cuda, B, S, H, Hkv, D, torch.bfloat16)
    lens = torch.tensor([32768, 1, 17, 4095, 16384, 32767, 20000, 8], dtype=torch.int32,
                        device=cuda)
    got = ops.decode_attention(q, k, v, lens)
    torch.testing.assert_close(
        got.float(), ref.decode_attention(q, k, v, lens).float(), rtol=2.0**-7, atol=1e-6
    )
    assert torch.equal(got, pfa.flash_decode_cuda(q, k, v, lens))


@pytest.mark.parametrize("nsplit", [1, 2, 7, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_takes_any_split_count(cuda, monkeypatch, nsplit, dtype):
    """Forced split counts, from none to more splits than some rows have
    tiles, give the plain version's answer, each twice the same bits."""
    B, S, H, Hkv, D = 3, 1000, 40, 8, 128
    q, k, v = _decode_inputs(cuda, B, S, H, Hkv, D, dtype, seed=4)
    lens = torch.tensor([1000, 77, 513], dtype=torch.int32, device=cuda)
    monkeypatch.setattr(pfa, "num_splits", lambda *args: nsplit)
    got = pfa.flash_decode_cuda(q, k, v, lens)
    rtol, atol = DECODE_TOL[dtype]
    torch.testing.assert_close(
        got.float(), ref.decode_attention(q, k, v, lens).float(), rtol=rtol, atol=atol
    )
    assert torch.equal(got, pfa.flash_decode_cuda(q, k, v, lens))


@pytest.mark.parametrize("nsplit", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_log_sum_exp_matches_plain(cuda, monkeypatch, nsplit, dtype):
    """``return_lse``: each head's log-sum-exp against the plain twin (f32
    within 1e-5, bf16 one step), -inf exactly where ``kv_len = 0``, over one
    split and over the split path, with ``kv_len > S``; the output is
    bitwise the call without it."""
    monkeypatch.setattr(pfa, "num_splits", lambda *a: nsplit)
    B, S, H, Hkv, D = 4, 512, 40, 8, 128
    q, k, v = _decode_inputs(cuda, B, S, H, Hkv, D, dtype)
    lens = torch.tensor([0, 1, 300, S + 9], dtype=torch.int32, device=cuda)
    plain = pfa.flash_decode_cuda(q, k, v, lens)
    got, lse = ops.decode_attention(q, k, v, lens, return_lse=True)
    assert torch.equal(got, plain)
    want_out, want = ref.decode_attention(q, k, v, lens, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.isinf(lse[0]).all() and (lse[0] < 0).all() and torch.isfinite(lse[1:]).all()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(lse[1:], want[1:], rtol=tol, atol=tol)


def test_flash_decode_reads_a_layer_of_the_stacked_cache_in_place(cuda):
    """A layer of (L, B, S, Hkv, D), and a batch-strided view: strides, no
    copy, the same answer as the contiguous cache."""
    L, B, S, H, Hkv, D = 3, 2, 300, 10, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(1)
    kc = torch.randn(L, 2 * B, S, Hkv, D, generator=gen, device=cuda).to(torch.bfloat16)
    vc = torch.randn(L, 2 * B, S, Hkv, D, generator=gen, device=cuda).to(torch.bfloat16)
    q = torch.randn(B, H, D, generator=gen, device=cuda).to(torch.bfloat16)
    lens = torch.tensor([7, 300], dtype=torch.int32, device=cuda)
    k, v = kc[1, ::2], vc[1, ::2]
    got = ops.decode_attention(q, k, v, lens)
    assert torch.equal(got, ops.decode_attention(q, k.contiguous(), v.contiguous(), lens))
    torch.testing.assert_close(
        got.float(), ref.decode_attention(q, k, v, lens).float(), rtol=2.0**-7, atol=1e-6
    )


def test_serving_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(ValueError, match="last axis"):
        ops.rmsnorm(x, torch.ones(63, device=cuda))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rmsnorm(x, torch.ones(64))
    q, k, v = _decode_inputs(cuda, 2, 64, 4, 2, 64, torch.float32)
    lens = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.decode_attention(q, k, v, lens.long())
    for d in (48, 256):  # built for D in (64, 128) only
        qd, kd, vd = _decode_inputs(cuda, 2, 64, 4, 2, d, torch.float32)
        with pytest.raises(ValueError, match="head dim"):
            ops.decode_attention(qd, kd, vd, lens)
    with pytest.raises(TypeError):  # f32 and bf16 only
        ops.decode_attention(q.half(), k.half(), v.half(), lens)
    strided_d = torch.randn(2, 64, 2, 128, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(q, strided_d, v, lens)


# ---------------------------------------------------------------------------
# the training kernels: flash attention forward and backward and the
# rmsnorm backward, against autograd through their plain versions
# ---------------------------------------------------------------------------

# f32: 1e-4, the reference's flash-attention tolerance (sums in another
# order).  bf16: the kernels' outputs against the plain version in f32 on
# the same bf16 inputs.  Each output is an f32 value rounded once to bf16,
# so within one bf16 step (rtol 2^-7); atol 1e-5 of the largest magnitude
# covers entries near zero.  The attention gradients also see the forward
# output rounded to bf16 inside delta = rowsum(dO * O), as FlashAttention-2
# does: that moves dS by up to a bf16 step of delta, so they are held to
# 1e-2 of their largest magnitude.
ATTN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0**-7, 1e-5)}
ATTN_GRAD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0**-7, 1e-2)}


def _close_to_scale(got, want, rtol, scale_atol, what=""):
    """atol is a share of want's largest magnitude, with a floor of 1e-6
    for gradients that vanish (window 1: a row sees only itself, so dS =
    p * (dP - delta) is 0 up to f32 rounding of two equal sums)."""
    want = want.float()
    atol = max(scale_atol * float(want.abs().max()), 1e-6)
    torch.testing.assert_close(
        got.float(), want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}"
    )


def _attn_inputs(cuda, B, S, H, Hkv, D, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = (0.5 * torch.randn(B, S, H, D, generator=gen, device=cuda)).to(dtype)
    k = (0.5 * torch.randn(B, S, Hkv, D, generator=gen, device=cuda)).to(dtype)
    v = (0.5 * torch.randn(B, S, Hkv, D, generator=gen, device=cuda)).to(dtype)
    do = torch.randn(B, S, H, D, generator=gen, device=cuda).to(dtype)
    return q, k, v, do


ATTN_CASES = [
    # the reference sweeps (tests/test_kernels.py), causal and not
    (1, 256, 4, 4, 64, True, 0),
    (1, 256, 8, 2, 64, True, 0),
    (1, 128, 4, 1, 128, True, 0),
    (1, 256, 4, 4, 64, False, 0),
    (1, 256, 8, 2, 64, False, 0),
    (1, 128, 4, 1, 128, False, 0),
    (1, 256, 2, 2, 64, True, 64),  # the reference's windowed case
    (2, 512, 40, 8, 128, True, 0),  # a qwen2.5-14b tile: 40/8 heads of 128
    # granite-20b's MQA: 48 query heads over 1 kv head of 128
    pytest.param(2, 512, 48, 1, 128, True, 0, id="mqa-causal"),
    pytest.param(1, 256, 48, 1, 128, False, 0, id="mqa-full"),
    (2, 384, 4, 2, 64, True, 100),  # a window off the tile grid
    (1, 256, 4, 2, 128, True, 1),  # window 1: the diagonal alone
    (2, 96, 4, 2, 64, True, 0),  # S below 128, not a multiple of the tile
    (1, 40, 2, 1, 128, False, 0),
    # bf16: dK/dV split over 8 blocks of one query head each (dkdv_splits)
    pytest.param(1, 256, 8, 1, 64, True, 0, id="dkdv-split"),
]


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(cuda, B, S, H, Hkv, D, causal, window, dtype):
    q, k, v, do = _attn_inputs(cuda, B, S, H, Hkv, D, dtype)
    counts = ops.launch_counts()
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = ops.attention(*leaves, causal=causal, window=window)
    grads = torch.autograd.grad(out, leaves, do)
    after = ops.launch_counts()
    assert after["flash_attention"] == counts["flash_attention"] + 1
    assert after["flash_attention_bwd"] == counts["flash_attention_bwd"] + 1
    assert out.dtype == dtype and out.shape == q.shape
    f32 = [t.float() for t in (q, k, v, do)]
    want = ref.attention(*f32[:3], causal=causal, window=window)
    rtol, atol = ATTN_TOL[dtype]
    _close_to_scale(out, want, rtol, atol, "o")
    want_grads = ref.attention_bwd(*f32, causal=causal, window=window)
    rtol, atol = ATTN_GRAD_TOL[dtype]
    for name, got, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert got.dtype == dtype and got.shape == w.shape
        _close_to_scale(got, w, rtol, atol, name)


@pytest.mark.parametrize(
    "B,S,H,Hkv,D,scale",
    [
        pytest.param(1, 256, 32, 8, 128, 1 / 128, id="granite-4.0-h"),  # GQA 32/8 of 128 at 1/128
        (2, 256, 8, 2, 64, 0.5),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_a_scale(cuda, B, S, H, Hkv, D, scale, dtype):
    """A scale of the model's own in both directions, against the plain
    version at that scale; no scale is 1/sqrt(D), bit for bit."""
    q, k, v, do = _attn_inputs(cuda, B, S, H, Hkv, D, dtype, seed=9)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = ops.attention(*leaves, scale=scale)
    grads = torch.autograd.grad(out, leaves, do)
    f32 = [t.float() for t in (q, k, v, do)]
    _close_to_scale(out, ref.attention(*f32[:3], scale=scale), *ATTN_TOL[dtype], "o")
    for name, got, w in zip(("dq", "dk", "dv"), grads, ref.attention_bwd(*f32, scale=scale)):
        _close_to_scale(got, w, *ATTN_GRAD_TOL[dtype], name)
    o, lse = pfa.flash_attention_cuda(q, k, v)
    o2, lse2 = pfa.flash_attention_cuda(q, k, v, scale=1 / D**0.5)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    g, g2 = pfa.flash_attention_bwd_cuda(q, k, v, o, lse, do), pfa.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, scale=1 / D**0.5
    )
    assert all(torch.equal(a, b) for a, b in zip(g, g2))
    with pytest.raises(RuntimeError, match="CUDA error"):
        pfa.flash_attention_cuda(q, k, v, scale=0.0)


def test_flash_attention_reads_strided_views_and_is_deterministic(cuda):
    """q, k and v as views of one packed (B, S, H + 2 Hkv, D) projection:
    read through their strides, the same answer as contiguous copies, and
    the backward twice gives the same bits."""
    B, S, H, Hkv, D = 2, 256, 8, 2, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(B, S, H + 2 * Hkv, D, generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H : H + Hkv], qkv[:, :, H + Hkv :]
    do = torch.randn(B, S, H, D, generator=gen, device=cuda).to(torch.bfloat16)
    o, lse = pfa.flash_attention_cuda(q, k, v)
    o2, lse2 = pfa.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    g1 = pfa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    g2 = pfa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    # an output gradient whose rows start off a 16-byte boundary
    do_odd = torch.empty(do.numel() + 1, dtype=do.dtype, device=cuda)[1:].view_as(do)
    do_odd.copy_(do)
    for a, b in zip(pfa.flash_attention_bwd_cuda(q, k, v, o, lse, do_odd), g1):
        assert torch.equal(a, b)
    want = ref.attention(q.float(), k.float(), v.float())
    _close_to_scale(o, want, *ATTN_TOL[torch.bfloat16])
    # lse is each row's log-sum-exp of its scaled, masked logits
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(4, dim=2))
    mask = torch.ones(S, S, dtype=torch.bool, device=cuda).tril()
    logits = torch.where(mask, logits / D**0.5, -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("nsplit", [1, 2, 4, 12])
def test_flash_attention_backward_splits_the_group(cuda, monkeypatch, nsplit):
    """The bf16 dK/dV grid split over nsplit blocks per kv head, each with
    12 / nsplit query heads, its partial sums added in order: the plain
    version's gradients at ATTN_GRAD_TOL, and the same bits twice."""
    monkeypatch.setattr(pfa, "dkdv_splits", lambda *args: nsplit)
    q, k, v, do = _attn_inputs(cuda, 2, 256, 12, 1, 128, torch.bfloat16, seed=5)
    o, lse = pfa.flash_attention_cuda(q, k, v)
    grads = pfa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    again = pfa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    want = ref.attention_bwd(*(t.float() for t in (q, k, v, do)))
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        _close_to_scale(got, w, *ATTN_GRAD_TOL[torch.bfloat16], name)


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _attn_inputs(cuda, 1, 256, 4, 2, 64, torch.float32)
    for d in (32, 96, 256):  # built for D in (64, 128) only
        qd, kd, vd, _ = _attn_inputs(cuda, 1, 128, 4, 2, d, torch.float32)
        with pytest.raises(ValueError, match="head dim"):
            ops.attention(qd, kd, vd)
    with pytest.raises(TypeError):  # f32 and bf16 only
        ops.attention(q.half(), k.half(), v.half())
    q2, k2, v2, _ = _attn_inputs(cuda, 1, 200, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="divide"):
        ops.attention(q2, k2, v2)
    with pytest.raises(ValueError, match="heads"):
        ops.attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pfa.flash_attention_cuda(q.cpu(), k.cpu(), v.cpu())
    strided_d = torch.randn(1, 256, 2, 128, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(q, strided_d, v)
    # bf16 rows are copied in 16-byte chunks: a view whose rows start off a
    # 16-byte boundary is refused, not read wrongly
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    padded = torch.randn(1, 256, 2, 65, device=cuda).bfloat16()
    for bad in (padded[..., :64], padded[..., 1:]):
        with pytest.raises(ValueError, match="16-byte"):
            ops.attention(qb, bad, vb)
    odd = torch.randn(1 * 256 * 4 * 64 + 1, device=cuda).bfloat16()[1:].view(1, 256, 4, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ops.attention(odd, kb, vb)


@pytest.mark.parametrize(
    "shape",
    [
        (8, 128),
        (16, 1024),
        (4, 5120),
        (3, 1001),
        (2, 3, 6000),
        (1, 20000),
        (600, 64),
        (2, 300, 768),  # mamba2-130m's d_model and d_inner
        (2, 300, 1536),
        # the team edges (LN_SHAPES'): a warp's registers and one vector
        # past them, eight warps' and one and two vectors past them, teams
        # that walk many rows
        (2, 776),
        (3, 6144),
        (3, 6148),
        (3, 6152),
        (1000, 768),
        (900, 6144),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype", [torch.float32, "same"])
def test_rmsnorm_backward_kernel_matches_plain(cuda, shape, dtype, wdtype):
    wdtype = dtype if wdtype == "same" else wdtype
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (1 + 0.3 * torch.randn(shape[-1], generator=gen, device=cuda)).to(wdtype)
    dy = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    before = ops.launch_counts()
    xg, wg = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    dx, dw = torch.autograd.grad(ops.rmsnorm(xg, wg), (xg, wg), dy)
    after = ops.launch_counts()
    assert after["rmsnorm"] == before["rmsnorm"] + 1
    assert after["rmsnorm_bwd"] == before["rmsnorm_bwd"] + 1
    assert dx.dtype == dtype and dw.dtype == wdtype and dx.shape == x.shape
    want_dx, want_dw = ref.rmsnorm_bwd(x.float(), w.float(), dy.float())
    _close_to_scale(dx, want_dx, *ATTN_TOL[dtype], "dx")
    _close_to_scale(dw, want_dw, *ATTN_TOL[wdtype], "dw")
    again = pnorms.rmsnorm_bwd_cuda(x, w, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)  # deterministic


def test_rmsnorm_backward_refuses_what_it_does_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(ValueError, match="width"):
        wide = torch.randn(2, 60000, device=cuda)
        pnorms.rmsnorm_bwd_cuda(wide, torch.ones(60000, device=cuda), wide)
    with pytest.raises(ValueError, match="rmsnorm_bwd"):
        pnorms.rmsnorm_bwd_cuda(x, torch.ones(64, device=cuda), x[:2])
    with pytest.raises(TypeError):
        pnorms.rmsnorm_bwd_cuda(x, torch.ones(64, device=cuda), x.half())


# ---------------------------------------------------------------------------
# layer norm, forward and backward, against the plain version
# ---------------------------------------------------------------------------

LN_SHAPES = [
    (8, 128),
    (16, 1024),
    (4, 6144),  # granite-20b's width, serving
    (3, 1001),
    (2, 3, 6000),
    (1, 20000),
    (600, 64),
    (2, 300, 256),  # rows not a multiple of any tile or block count
    # the forward's edges (as rmsnorm's): a warp's budget and one vector
    # past it, eight warps' and one vector past it in f32 and in bf16,
    # mamba2-130m's widths, teams that walk several rows
    (2, 776),
    (3, 6144),
    (3, 6148),
    (3, 6152),
    (1000, 768),
    (9, 1536),
    (900, 6144),
]


@pytest.mark.parametrize("shape", LN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("wdtype", [torch.float32, "same"])
def test_layernorm_kernel_matches_plain(cuda, shape, dtype, wdtype):
    """rmsnorm's tolerances (RMS_TOL): the sums run in another order."""
    wdtype = dtype if wdtype == "same" else wdtype
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (1 + 0.3 * torch.randn(shape[-1], generator=gen, device=cuda)).to(wdtype)
    b = (0.3 * torch.randn(shape[-1], generator=gen, device=cuda)).to(wdtype)
    before = ops.launch_counts()["layernorm"]
    got = ops.layernorm(x, w, b)
    assert ops.launch_counts()["layernorm"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    rtol, atol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.layernorm(x, w, b).float(), rtol=rtol, atol=atol)


def test_layernorm_rows_off_a_16_byte_boundary_and_with_a_large_mean(cuda):
    """Unaligned rows take scalar loads.  Rows at a mean of 300 (spread 1):
    the two-pass variance keeps its digits; the mean's own f32 rounding
    (an ulp of 300 is 3e-5) differs between the kernel's and the plain
    version's summation orders, so 1e-4 there."""
    base = torch.randn(3 * 1001 + 1, device=cuda)
    x = base[1:].view(3, 1001)
    w, b = torch.randn(1001, device=cuda), torch.randn(1001, device=cuda)
    torch.testing.assert_close(ops.layernorm(x, w, b), ref.layernorm(x, w, b), rtol=1e-5, atol=1e-5)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = 300.0 + torch.randn(8, 6144, generator=gen, device=cuda)
    w = 1 + 0.3 * torch.randn(6144, generator=gen, device=cuda)
    b = 0.3 * torch.randn(6144, generator=gen, device=cuda)
    got = ops.layernorm(x, w, b)
    torch.testing.assert_close(got, ref.layernorm(x, w, b), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, ref.layernorm(x - 300.0, w, b), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape", LN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype", [torch.float32, "same"])
def test_layernorm_backward_kernel_matches_plain(cuda, shape, dtype, wdtype):
    """Autograd through LayerNormFn against autograd through the plain
    version in f32, at the rmsnorm backward's tolerances; the backward
    twice gives the same bits (no atomics)."""
    wdtype = dtype if wdtype == "same" else wdtype
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (1.0 + torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    w = (1 + 0.3 * torch.randn(shape[-1], generator=gen, device=cuda)).to(wdtype)
    b = (0.3 * torch.randn(shape[-1], generator=gen, device=cuda)).to(wdtype)
    dy = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    before = ops.launch_counts()
    leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
    dx, dw, db = torch.autograd.grad(ops.layernorm(*leaves), leaves, dy)
    after = ops.launch_counts()
    assert after["layernorm"] == before["layernorm"] + 1
    assert after["layernorm_bwd"] == before["layernorm_bwd"] + 1
    assert dx.dtype == dtype and dw.dtype == db.dtype == wdtype and dx.shape == x.shape
    want = ref.layernorm_bwd(x.float(), w.float(), b.float(), dy.float())
    _close_to_scale(dx, want[0], *ATTN_TOL[dtype], "dx")
    _close_to_scale(dw, want[1], *ATTN_TOL[wdtype], "dw")
    _close_to_scale(db, want[2], *ATTN_TOL[wdtype], "db")
    again = pnorms.layernorm_bwd_cuda(x, w, dy)
    for a, g in zip(again, (dx, dw, db)):
        assert torch.equal(a, g)


@pytest.mark.parametrize("centred", [False, True], ids=["rmsnorm", "layernorm"])
@pytest.mark.parametrize("shape", [(5, 768), (3, 6144), (4, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_backwards_take_rows_off_a_16_byte_boundary(cuda, centred, shape, dtype):
    """x and dy one element past a 16-byte boundary (both, then dy alone)
    take the scalar loads; the same gradients as the plain version, and the
    same bits twice."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = shape[0] * shape[1]
    x = (1.0 + torch.randn(n + 1, generator=gen, device=cuda)).to(dtype)[1:].view(shape)
    dy = torch.randn(n + 1, generator=gen, device=cuda).to(dtype)[1:].view(shape)
    w = 1 + 0.3 * torch.randn(shape[-1], generator=gen, device=cuda)
    b = 0.3 * torch.randn(shape[-1], generator=gen, device=cuda)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    for xs in (x, x.clone()):
        if centred:
            got = pnorms.layernorm_bwd_cuda(xs, w, dy)
            want = ref.layernorm_bwd(xs.float(), w, b, dy.float())
        else:
            got = pnorms.rmsnorm_bwd_cuda(xs, w, dy)
            want = ref.rmsnorm_bwd(xs.float(), w, dy.float())
        tols = (ATTN_TOL[dtype], ATTN_TOL[torch.float32], ATTN_TOL[torch.float32])
        for name, g, wt, tol in zip(("dx", "dw", "db"), got, want, tols):
            _close_to_scale(g, wt, *tol, name)
        again = (pnorms.layernorm_bwd_cuda if centred else pnorms.rmsnorm_bwd_cuda)(xs, w, dy)
        for a, g in zip(again, got):
            assert torch.equal(a, g)


def test_layernorm_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="width"):
        wide = torch.randn(2, 30000, device=cuda)
        pnorms.layernorm_bwd_cuda(wide, torch.ones(30000, device=cuda), wide)
    with pytest.raises(ValueError, match="layernorm_bwd"):
        pnorms.layernorm_bwd_cuda(x, w, x[:2])
    with pytest.raises(TypeError):  # b shares w's dtype
        pnorms.layernorm_cuda(x, w, w.half())
    with pytest.raises(ValueError, match="last axis"):
        pnorms.layernorm_cuda(x, w[:32], w[:32])
    with pytest.raises(ValueError, match="CUDA tensor"):
        pnorms.layernorm_cuda(x.cpu(), w, w)


def _at_model_fan_in(params) -> None:
    """Scale every attention block's wq and wk, (..., d, H, Dh), in place
    from the reference's fan-in (the head count) to one of d_model."""
    for sub in params.values():
        if isinstance(sub, dict):
            if "wq" in sub:
                for name in ("wq", "wk"):
                    sub[name].mul_((sub[name].shape[-2] / sub[name].shape[-3]) ** 0.5)
            else:
                _at_model_fan_in(sub)


# the model train steps held card against CPU: (config, overrides, tokens a
# row, leaves (dotted paths) drawn N(0, 0.5^2) as they start at zero,
# kernels that must launch, gradient tolerance as a share of its largest
# magnitude)
TRAIN_STEP_CASES = [
    pytest.param(
        "qwen2.5-14b-smoke",
        dict(d_model=128, n_heads=4, n_kv=2, d_head=64),
        128,
        (),
        ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd"),
        1e-3,
        id="dense",
    ),
    pytest.param(
        "mamba2-130m-smoke",
        {},
        256,
        ("layers.mamba.A_log", "layers.mamba.dt_bias"),
        ("ssd_scan", "ssd_scan_bwd", "rmsnorm", "rmsnorm_bwd"),
        1e-4,
        id="ssm",
    ),
    # granite: layer norms with biases, MQA, the gelu MLP; heads of 64
    # (the attention kernels' smallest D) where the smoke config has 16
    pytest.param(
        "granite-20b-smoke",
        dict(d_model=128, n_heads=4, n_kv=1, d_head=64),
        128,
        ("layers.ln1_b", "layers.ln2_b", "final_norm_b"),
        ("flash_attention", "flash_attention_bwd", "layernorm", "layernorm_bwd"),
        1e-3,
        id="granite",
    ),
    # seamless: the encoder and the cross-attention non-causal, the decoder
    # causal, layer norms with biases in both stacks; heads of 64
    pytest.param(
        "seamless-m4t-large-v2-smoke",
        dict(d_model=128, n_heads=2, n_kv=2, d_head=64),
        128,
        ("enc_layers.ln1_b", "dec_layers.lnx_b", "enc_norm_b", "final_norm_b"),
        ("flash_attention", "flash_attention_bwd", "layernorm", "layernorm_bwd"),
        1e-3,
        id="encdec",
    ),
]


@pytest.mark.parametrize("arch,overrides,seq,drawn,kernels,grad_tol", TRAIN_STEP_CASES)
def test_training_step_on_the_card_matches_the_cpu(
    cuda, arch, overrides, seq, drawn, kernels, grad_tol
):
    """loss_and_grads of a 2-layer model, f32, remat on: the card (the
    kernels) against the CPU (the plain versions), the loss within 1e-5
    and every gradient within ``grad_tol`` of its largest magnitude.

    dense and granite (64-wide heads, the kernels' smallest D): 1e-3, not
    tighter: a
    1e-7 relative nudge to the dense model's weights moves its gradients
    by up to 2.8e-4 of their largest magnitude (measured on the CPU), since
    the reference's init rule (fan_in = the head count for wq and wk),
    granite's too, makes the attention nearly one-hot, and the card's f32 sums round apart from
    the CPU's.  ssm (d 64, N 16, P 16): no attention, so the SSD kernels'
    own 1e-4 (their tiles sum in another order than the plain form's
    chunk).  encdec (heads of 64): the dense case's 1e-3, with every
    attention's wq and wk at a fan-in of d_model (``_at_model_fan_in``),
    as the CPU tests draw them: at the reference's init three attentions
    a layer pair amplify f32 rounding to 8e-3 of the embedding's
    gradient.  The kernels' own tolerances are held above."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.parallel import steps

    cfg = dataclasses.replace(registry.get(arch), remat="full", **overrides)
    gen = torch.Generator().manual_seed(0)
    cpu = init_params(steps.model_specs(cfg), gen, "cpu")
    for path in drawn:
        t = cpu
        for key in path.split("."):
            t = t[key]
        t.copy_(0.5 * torch.randn(t.shape, generator=gen))
    if cfg.family == "encdec":
        _at_model_fan_in(cpu)
    card = tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.randint(0, cfg.vocab, (2, seq + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frontend"] = torch.randn(2, seq, cfg.d_model, generator=gen)
    counts = ops.launch_counts()
    loss_c, grads_c = steps.loss_and_grads(cfg, card, {k: t.to(cuda) for k, t in batch.items()})
    after = ops.launch_counts()
    for name in kernels:
        assert after[name] > counts[name], name
    loss, grads = steps.loss_and_grads(cfg, cpu, batch)
    assert abs(float(loss_c) - float(loss)) <= 1e-5 * abs(float(loss))

    def check(got, want, path=""):
        if isinstance(want, dict):
            for key in want:
                check(got[key], want[key], f"{path}.{key}")
        else:
            _close_to_scale(got.cpu(), want, grad_tol, grad_tol, path)

    check(grads_c, grads)


# ---------------------------------------------------------------------------
# the SSD scan, forward and backward, against the plain chunked form
# ---------------------------------------------------------------------------

# f32 only; the kernels' tile (64 or 32 rows) is not the plain form's chunk,
# so sums run in another order: 1e-4 of the largest magnitude, as the
# attention kernels (the reference holds its kernel to 1e-3 against the
# sequential oracle)
SSD_TOL = (1e-4, 1e-4)


def _ssd_inputs(cuda, B, S, H, P, N, seed=0):
    """Model-like inputs: a = -softplus(.) as mamba2_apply makes it."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = 0.5 * torch.randn(B, S, H, P, generator=gen, device=cuda)
    a = -torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device=cuda) - 1)
    b = 0.3 * torch.randn(B, S, N, generator=gen, device=cuda)
    c = 0.3 * torch.randn(B, S, N, generator=gen, device=cuda)
    dy = torch.randn(B, S, H, P, generator=gen, device=cuda)
    return x, a, b, c, dy


SSD_CASES = [(2, 256, 3, P, N) for P in pssd.HEAD_DIMS for N in pssd.STATE_SIZES] + [
    # the reference sweeps (tests/test_kernels.py), a tail tile, a sequence
    # shorter than a tile, and a mamba2-130m layer at batch 1
    (1, 256, 2, 64, 32),
    (1, 128, 4, 32, 16),
    (1, 512, 1, 128, 64),
    (2, 200, 3, 64, 128),
    (3, 8, 2, 16, 16),
    (1, 1024, 24, 64, 128),
]


@pytest.mark.parametrize("B,S,H,P,N", SSD_CASES)
def test_ssd_scan_kernels_match_plain(cuda, B, S, H, P, N):
    x, a, b, c, dy = _ssd_inputs(cuda, B, S, H, P, N)
    chunk = S if S % 128 else 128  # the plain form's chunk must divide S
    counts = ops.launch_counts()
    leaves = [t.detach().requires_grad_(True) for t in (x, a, b, c)]
    y = ops.ssd_scan(*leaves, chunk=chunk)
    grads = torch.autograd.grad(y, leaves, dy)
    after = ops.launch_counts()
    assert after["ssd_scan"] == counts["ssd_scan"] + 1
    assert after["ssd_scan_bwd"] == counts["ssd_scan_bwd"] + 1
    assert y.dtype == torch.float32 and y.shape == x.shape
    _close_to_scale(y, ref.ssd_scan_chunked(x, a, b, c, chunk=chunk), *SSD_TOL, "y")
    want = ref.ssd_scan_bwd(x, a, b, c, dy, chunk=chunk)
    for name, got, w in zip(("dx", "da", "db", "dc"), grads, want):
        assert got.shape == w.shape
        _close_to_scale(got, w, *SSD_TOL, name)


def test_ssd_scan_reads_strided_views_and_is_deterministic(cuda):
    """b and c as slices of one (B, S, H*P + 2N) tensor, x a view of it:
    read through their strides, the same bits as contiguous copies, and
    each kernel twice gives the same bits, forward and backward, over a
    sequence of many tiles (S = 1,280 with a tail: 21 tiles of 64)."""
    B, S, H, P, N = 2, 1300, 4, 64, 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    packed = torch.randn(B, S, H * P + 2 * N, generator=gen, device=cuda)
    x = packed[..., : H * P].unflatten(-1, (H, P))
    b, c = packed[..., H * P : H * P + N], packed[..., H * P + N :]
    a = -torch.rand(B, S, 2 * H, generator=gen, device=cuda)[..., ::2]
    dy = torch.randn(B, S, H, P, generator=gen, device=cuda)
    dense = [t.contiguous() for t in (x, a, b, c)]
    y, states = pssd.ssd_scan_cuda(x, a, b, c, keep_states=True)
    y2, states2 = pssd.ssd_scan_cuda(*dense, keep_states=True)
    assert torch.equal(y, y2) and torch.equal(states, states2)
    assert torch.equal(pssd.ssd_scan_cuda(x, a, b, c)[0], y)
    g1 = pssd.ssd_scan_bwd_cuda(x, a, b, c, states, dy)
    g2 = pssd.ssd_scan_bwd_cuda(x, a, b, c, states, dy)
    g3 = pssd.ssd_scan_bwd_cuda(*dense, states2, dy)
    for g, h, k in zip(g1, g2, g3):
        assert torch.equal(g, h) and torch.equal(g, k)
    _close_to_scale(y, ref.ssd_scan_chunked(x, a, b, c, chunk=S), *SSD_TOL, "y")
    want = ref.ssd_scan_bwd(*dense, dy, chunk=S)
    for name, got, w in zip(("dx", "da", "db", "dc"), g1, want):
        _close_to_scale(got, w, *SSD_TOL, name)


def _ssd_check_both(x, a, b, c, dy, chunk):
    """Forward and backward through the kernels, each against the plain
    chunked form and autograd through it at SSD_TOL."""
    y, states = pssd.ssd_scan_cuda(x, a, b, c, keep_states=True)
    grads = pssd.ssd_scan_bwd_cuda(x, a, b, c, states, dy)
    _close_to_scale(y, ref.ssd_scan_chunked(x, a, b, c, chunk=chunk), *SSD_TOL, "y")
    want = ref.ssd_scan_bwd(x, a, b, c, dy, chunk=chunk)
    for name, got, w in zip(("dx", "da", "db", "dc"), grads, want):
        _close_to_scale(got, w, *SSD_TOL, name)
    return y, grads


def test_ssd_scan_long_sequence_carries_the_state_across_tiles(cuda):
    """A mamba2-130m layer over S = 4,096 at batch 1: the state crosses 64
    tiles of the chain, forward and backward."""
    _ssd_check_both(*_ssd_inputs(cuda, 1, 4096, 24, 64, 128, seed=3), chunk=128)


@pytest.mark.parametrize(
    "decay",
    [
        pytest.param(1e-4, id="near-zero"),  # long memory: errors would add up over tiles
        pytest.param(60.0, id="very-negative"),  # exp(A) underflows within a tile
    ],
)
def test_ssd_scan_extreme_decays(cuda, decay):
    B, S, H, P, N = 2, 2048, 4, 64, 128
    x, _, b, c, dy = _ssd_inputs(cuda, B, S, H, P, N, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = -decay * torch.rand(B, S, H, generator=gen, device=cuda)
    y, grads = _ssd_check_both(x, a, b, c, dy, chunk=128)
    for t in (y, *grads):
        assert bool(torch.isfinite(t).all())


def test_ssd_scan_batch_rows_are_their_own_chains(cuda):
    """Sequences that differ (scale, decay and one all zero): each batch
    row, through the batched kernels, gives the same bits as that row alone,
    so no tile reads another row's state or dL/dstate."""
    B, S, H, P, N = 3, 1024, 4, 64, 128
    x, a, b, c, dy = _ssd_inputs(cuda, B, S, H, P, N, seed=7)
    x = x * torch.tensor([1.0, 0.0, 30.0], device=cuda)[:, None, None, None]
    a = a * torch.tensor([1.0, 0.01, 3.0], device=cuda)[:, None, None]
    y, grads = _ssd_check_both(x, a, b, c, dy, chunk=128)
    for row in range(B):
        one = [t[row : row + 1] for t in (x, a, b, c, dy)]
        y1, states1 = pssd.ssd_scan_cuda(*one[:4], keep_states=True)
        assert torch.equal(y1, y[row : row + 1]), row
        for g1, g in zip(pssd.ssd_scan_bwd_cuda(*one[:4], states1, one[4]), grads):
            assert torch.equal(g1, g[row : row + 1]), row


def test_ssd_scan_refuses_what_it_does_not_take(cuda):
    x, a, b, c, _ = _ssd_inputs(cuda, 1, 128, 2, 64, 32)
    with pytest.raises(ValueError, match="not built"):
        pssd.ssd_scan_cuda(x[..., :48], a, b, c)
    with pytest.raises(ValueError, match="not built"):
        pssd.ssd_scan_cuda(x, a, b[..., :24], c[..., :24])
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x.bfloat16(), a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        pssd.ssd_scan_cuda(x, a, b.transpose(1, 2).contiguous().transpose(1, 2), c)
    with pytest.raises(ValueError, match="divide"):
        ops.ssd_scan(x[:, :100], a[:, :100], b[:, :100], c[:, :100], chunk=64)
    with pytest.raises(ValueError, match="CUDA"):
        pssd.ssd_scan_cuda(x.cpu(), a, b, c)


# ---------------------------------------------------------------------------
# the kernels at the hybrid (zamba2-1.2b) and VLM (llava-next-34b) shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "H,Hkv,D,causal,window",
    [
        pytest.param(32, 32, 64, True, 4096, id="zamba2-shared-block"),  # g = 1, D 64, windowed
        pytest.param(56, 8, 128, True, 0, id="llava"),  # g = 7
        pytest.param(16, 16, 64, False, 0, id="seamless-encoder"),  # non-causal, D 64
    ],
)
def test_flash_attention_at_the_new_families_train_shapes(cuda, H, Hkv, D, causal, window):
    """bf16 forward and backward at S 4,096 (one sequence of the train
    shape) against the plain versions in f32, and bitwise twice.  D 64 at
    g = 1 is where a register-fragment path once went wrong (ROADMAP
    B.2.1); g = 7 must split dK/dV over a divisor of 7; seamless's encoder
    and cross-attention run it non-causal."""
    S = 4096
    mask = dict(causal=causal, window=window)
    q, k, v, do = _attn_inputs(cuda, 1, S, H, Hkv, D, torch.bfloat16, seed=11)
    o, lse = pfa.flash_attention_cuda(q, k, v, **mask)
    o2, lse2 = pfa.flash_attention_cuda(q, k, v, **mask)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    grads = pfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mask)
    for a, b in zip(grads, pfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mask)):
        assert torch.equal(a, b)
    f32 = [t.float() for t in (q, k, v, do)]
    _close_to_scale(o, ref.attention(*f32[:3], **mask), *ATTN_TOL[torch.bfloat16], "o")
    want = ref.attention_bwd(*f32, **mask)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        _close_to_scale(got, w, *ATTN_GRAD_TOL[torch.bfloat16], name)


def test_ssd_scan_at_the_zamba2_shape(cuda):
    """zamba2-1.2b's layer: 64 heads, P 64, N 64 (mamba2 runs N 128), S
    4,096 at batch 1, forward and backward against the plain chunked
    form, and bitwise twice."""
    x, a, b, c, dy = _ssd_inputs(cuda, 1, 4096, 64, 64, 64, seed=12)
    y, grads = _ssd_check_both(x, a, b, c, dy, chunk=128)
    y2, states = pssd.ssd_scan_cuda(x, a, b, c, keep_states=True)
    assert torch.equal(y, y2)
    for g, g2 in zip(grads, pssd.ssd_scan_bwd_cuda(x, a, b, c, states, dy)):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_on_a_full_ring(cuda, dtype):
    """zamba2-1.2b's shared block in decode: G 1, D 64, 32 heads over a
    ring of 4,096 rows (the window) whose kv_len is the whole ring, and
    one row short of it; bitwise twice."""
    B, W = 4, 4096
    q, k, v = _decode_inputs(cuda, B, W, 32, 32, 64, dtype, seed=13)
    lens = torch.tensor([W, W, W, W - 1], dtype=torch.int32, device=cuda)
    got = pfa.flash_decode_cuda(q, k, v, lens)
    assert torch.equal(got, pfa.flash_decode_cuda(q, k, v, lens))
    rtol, atol = DECODE_TOL[dtype]
    torch.testing.assert_close(
        got.float(), ref.decode_attention(q, k, v, lens).float(), rtol=rtol, atol=atol
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_over_the_cross_memory(cuda, dtype):
    """seamless-m4t-large-v2's cross-attention in decode: G 1, D 64, 16
    heads over the 3,072-row encoder memory, read whole; bitwise twice."""
    B, Se = 4, 3072
    q, k, v = _decode_inputs(cuda, B, Se, 16, 16, 64, dtype, seed=14)
    lens = torch.full((B,), Se, dtype=torch.int32, device=cuda)
    got = pfa.flash_decode_cuda(q, k, v, lens)
    assert torch.equal(got, pfa.flash_decode_cuda(q, k, v, lens))
    rtol, atol = DECODE_TOL[dtype]
    torch.testing.assert_close(
        got.float(), ref.decode_attention(q, k, v, lens).float(), rtol=rtol, atol=atol
    )


def test_encdec_decode_step_on_the_card_matches_the_cpu(cuda):
    """The encoder-decoder decode step over a memory that is not zero
    (``encode`` of random frames, each layer's ``_mem_kv``), f32, heads of
    64, the attention at a fan-in of d_model (``_at_model_fan_in``): the card (layernorm, flash_decode over the self cache and the
    cross memory) against the CPU, the memory within 1e-4 of its scale and
    the logits and the written K/V within 1e-4 of theirs, each kernel
    launched."""
    from repro_torch.configs import registry
    from repro_torch.models import encdec
    from repro_torch.models.lm import _layer
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.parallel import steps

    cfg = dataclasses.replace(
        registry.get("seamless-m4t-large-v2-smoke"), d_model=128, n_heads=2, n_kv=2, d_head=64
    )
    gen = torch.Generator().manual_seed(0)
    cpu = init_params(steps.model_specs(cfg), gen, "cpu")
    _at_model_fan_in(cpu)
    card = tree_map(lambda t: t.to(cuda), cpu)
    frames = torch.randn(2, 256, cfg.d_model, generator=gen)
    caches = []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        mem = encdec.encode(cfg, params, frames.to(dev))
        cache = init_params(encdec.cache_specs(cfg, 2, 16, 256), None, dev)
        for i in range(cfg.n_layers):
            k, v = encdec._mem_kv(_layer(params["dec_layers"]["xattn"], i), mem)
            cache["xk"][i], cache["xv"][i] = k, v
        caches.append((mem, cache))
    _close_to_scale(caches[1][0].cpu(), caches[0][0], 1e-4, 1e-4, "memory")
    toks, pos = torch.tensor([3, 9]), torch.tensor([0, 5], dtype=torch.int32)
    counts = ops.launch_counts()
    got, card_cache = encdec.decode_step(cfg, card, caches[1][1], toks.to(cuda), pos.to(cuda))
    after = ops.launch_counts()
    assert after["flash_decode"] - counts["flash_decode"] == 2 * cfg.n_layers
    assert after["layernorm"] - counts["layernorm"] == 3 * cfg.n_layers + 1
    want, cpu_cache = encdec.decode_step(cfg, cpu, caches[0][1], toks, pos)
    _close_to_scale(got.cpu(), want, 1e-4, 1e-4, "logits")
    for leaf in ("k", "v"):
        _close_to_scale(card_cache[leaf].cpu(), cpu_cache[leaf], 1e-4, 1e-4, leaf)


# ---------------------------------------------------------------------------
# the runtime services on the card: streams, events, graphs
# ---------------------------------------------------------------------------

SLEEP_CYCLES = 200_000_000  # ~0.1 s of one SM's clock: the producer is late


@cox.kernel
def _svc_scale(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), n: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = x[i] * 3.0 + 1.0


@cox.kernel
def _svc_tile_sum(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), n: cox.i32):
    tile = c.shared((256,), cox.f32)
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    v = 0.0
    if i < n:
        v = x[i]
    tile[c.thread_idx()] = v
    c.syncthreads()
    s = 0.0
    for k in range(256):
        s += tile[k]
    out[c.block_idx()] = s


def _svc_launch(stream, x, n=2048):
    return stream.launch(_svc_scale, grid=n // 256, block=256, args=(torch.zeros_like(x), x, n))


def _late(stream, dev):
    """Queue a long sleep on the cox stream's torch stream: whatever it
    launches next runs late, so a reader that is not made to wait reads
    stale memory."""
    with torch.cuda.stream(stream.torch_stream(dev)):
        torch.cuda._sleep(SLEEP_CYCLES)


@pytest.mark.parametrize("edge", ["event", "data"])
def test_cross_stream_edges_are_device_waits(cuda, edge):
    """A consumer on stream B of a late producer on stream A reads the
    producer's output only after it is written: an event edge and a data
    edge each become a wait of B on A's recorded event (the consumer gets
    the output through a view for the event edge, so only the event
    orders it)."""
    d = cox.get_dispatcher()
    a, b = cox.Stream("prod", d), cox.Stream("cons", d)
    x = torch.randn(2048, device=cuda)
    _late(a, cuda)
    h1 = _svc_launch(a, x)
    if edge == "event":
        b.wait_event(a.record_event())
        src = h1.outputs["out"].view(-1)  # a new tensor object: no data edge
    else:
        src = h1.outputs["out"]
    h2 = _svc_launch(b, src)
    assert (h1.request.seq in h2.request.deps) == (edge == "event")
    assert (h1.request.seq in h2.request.data_deps) == (edge == "data"), (
        h2.request.data_deps,
        h1.request.done.query(),  # the producer is still late: an edge is needed
    )
    want = (x * 3.0 + 1.0) * 3.0 + 1.0
    assert torch.equal(h2.result()["out"], want)


def test_default_stream_legacy_sync_on_the_card(cuda):
    """The legacy barrier in both directions: a default-stream launch
    waits for every other stream's tail, and the next launch on another
    stream waits for the default stream (here, late torch work on it)."""
    d = cox.get_dispatcher()
    s1, s2 = cox.Stream("one", d), cox.Stream("two", d)
    x = torch.randn(2048, device=cuda)
    _late(s1, cuda)
    h1 = _svc_launch(s1, x)
    alias = h1.outputs["out"].view(-1)  # no data edge: only the barrier orders it
    hd = _svc_launch(d.default, alias)
    assert h1.request.seq in hd.request.deps
    torch.cuda._sleep(SLEEP_CYCLES)  # late work on the current stream
    h2 = _svc_launch(s2, hd.outputs["out"].view(-1))
    assert hd.request.seq in h2.request.deps
    want = ((x * 3.0 + 1.0) * 3.0 + 1.0) * 3.0 + 1.0
    assert torch.equal(h2.result()["out"], want)


def test_record_stream_keeps_a_cross_stream_block(cuda):
    """A producer's output, read late on another stream, is freed on the
    host while that stream still has to read it; torch's caching
    allocator must not hand its block to new work on the producer's
    stream before then (``record_stream`` on the reading stream)."""
    d = cox.get_dispatcher()
    a, b = cox.Stream("alloc", d), cox.Stream("reader", d)
    x = torch.randn(2048, device=cuda)
    h1 = _svc_launch(a, x)
    ev = a.record_event()
    b.wait_event(ev)
    _late(b, cuda)
    h2 = _svc_launch(b, h1.outputs["out"].view(-1))
    a.synchronize()
    del h1, ev
    d.flush()  # prunes the finished producer: its output is freed
    with torch.cuda.stream(a.torch_stream(cuda)):
        junk = [torch.full((2049,), 7.0, device=cuda) for _ in range(8)]
    assert torch.equal(h2.result()["out"], (x * 3.0 + 1.0) * 3.0 + 1.0)
    del junk


def test_token_pipeline_replays_a_cuda_graph_with_cloned_outputs(cuda):
    """The serving token pipeline captured once is a torch.cuda.CUDAGraph;
    a replay hands back clones (an earlier step's histogram is not
    overwritten by the next replay), and the statistics are bitwise the
    eager pipeline's."""
    from repro_torch.launch.serve import TokenPipeline

    g, e = TokenPipeline(4, graph=True), TokenPipeline(4, graph=False)
    gen = torch.Generator().manual_seed(3)
    kept = []
    for step in range(20):
        toks = torch.randint(0, 152064, (4,), generator=gen).numpy()
        active = (torch.rand(4, generator=gen) < 0.8).numpy()
        g.step(toks, active)
        e.step(toks, active)
        kept.append((g.hist, g.hist.clone()))
    assert isinstance(g.graph_exec.cuda_graph, torch.cuda.CUDAGraph)
    for held, snapshot in kept:
        assert torch.equal(held, snapshot)
    got, want = g.collect(), e.collect()
    for k in want:
        assert (got[k] == want[k]).all(), k
    assert g.hist.device.type == "cuda"


def test_capture_of_a_host_reading_kernel_is_refused(cuda):
    """A kernel whose launch reads flags back to the host (a 256-trip loop
    past the unroll limit) cannot be captured: instantiate raises
    CoxUnsupported naming it, and no replay -> eager rung is taken."""
    d = cox.get_dispatcher()
    s = cox.Stream("cap", d)
    x = torch.randn(2048, device=cuda)
    graph = cox.Graph()
    with graph.capture(s):
        s.launch(_svc_tile_sum, grid=8, block=256, args=(torch.zeros(8, device=cuda), x, 2048))
    before = d.degradations
    with pytest.raises(cox.CoxUnsupported, match="_svc_tile_sum.*host"):
        graph.instantiate()
    assert d.degradations == before
    # eager issue of the same launch still runs
    got = s.launch(_svc_tile_sum, grid=8, block=256, args=(torch.zeros(8, device=cuda), x, 2048))
    assert got.result()["out"].shape == (8,)


# ---------------------------------------------------------------------------
# the tuner and buffer donation on the card
# ---------------------------------------------------------------------------


def test_donation_lowers_the_launch_peak_by_the_donated_bytes(cuda):
    """A donating launch consumes the caller's 1-D device buffers once it
    holds its own copies, so its peak device memory is lower than the
    plain launch's by (about) their bytes; the outputs are the same and
    the consumed input is refused by a later launch."""
    n = 1 << 20

    def peak(donate):
        x = torch.arange(n, device=cuda, dtype=torch.float32)
        out = torch.zeros(n, device=cuda)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = _svc_scale.launch(grid=n // 1024, block=1024, args=(out, x, n), backend="vmap", donate=donate)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, got["out"], x

    plain, want, _ = peak(False)
    donating, got, x = peak(True)
    assert torch.equal(got, want)
    assert plain - donating >= 2 * 4 * n - (1 << 20), (plain, donating)
    assert x.numel() == 0
    with pytest.raises(cox.CoxUnsupported, match="donated"):
        _svc_scale.launch(grid=n // 1024, block=1024, args=(torch.zeros(n, device=cuda), x, n))


def test_tuning_is_skipped_inside_a_cuda_graph_capture(cuda, tmp_path, monkeypatch):
    """A request made while torch captures a CUDA graph keeps its
    heuristic knobs and measures nothing (a synchronize in the capture
    would raise); out of the capture the same request tunes."""
    from repro_torch.core import autotune

    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    autotune.reset()
    x = torch.randn(2048, device=cuda)
    args = (torch.zeros(8, device=cuda), x, 2048)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            y = x * 2.0
            req = _svc_tile_sum.make_request(grid=8, block=256, args=args, autotune=True)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2.0)
    assert req.rl.chunk_source == "heuristic" and autotune.stats()["misses"] == 0
    tuned = _svc_tile_sum.make_request(grid=8, block=256, args=args, autotune=True)
    assert autotune.stats()["misses"] == 1 and autotune.stats()["measurements"] > 0
    assert tuned.rl.chunk_source == "autotuned"
    autotune.reset()


@pytest.mark.parametrize("name", ["warpPrefixStats", "histogram64", "saxpyHeavy", "transpose"])
def test_tuned_launch_is_bitwise_the_scan_launch(cuda, name, tmp_path, monkeypatch):
    """A tuned launch on the card (its winner measured there, keyed to
    this card) is bitwise the serial scan launch."""
    from repro_torch.core import autotune

    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    autotune.reset()
    sk = SUITE[name]
    args = sk.make_args()
    want = sk.kernel.launch(grid=sk.grid, block=sk.block, args=args, backend="scan", warp_exec="serial")
    got = sk.kernel.launch(grid=sk.grid, block=sk.block, args=args, autotune=True)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    (rec,) = autotune.entries().values()
    assert torch.cuda.get_device_name(0).replace(" ", "_") in rec["fingerprint"]
    autotune.reset()


@cox.kernel
def _md_vec_madd(c, out: cox.Array(cox.f32), a: cox.Array(cox.f32), b: cox.Array(cox.f32), n: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = a[i] * 2.0 + b[i]


@cox.kernel
def _md_histogram(c, hist: cox.Array(cox.f32), data: cox.Array(cox.i32), n: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        c.atomic_add(hist, data[i], 1.0)


def test_nccl_one_rank_sharded_launch_is_the_scan_launch(cuda, tmp_path, monkeypatch):
    """A world-size-1 NCCL group (a file store, no network): vec_madd and
    the histogram atomics sharded over its one-rank mesh are bitwise the
    scan launch, on the card; the group is destroyed afterwards."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(2048, generator=gen)
    cases = [
        (_md_vec_madd, 8, 256, (torch.zeros(2048), a, torch.ones(2048), 2000)),
        (_md_histogram, 8, 128, (torch.zeros(16), torch.randint(0, 16, (1024,), generator=gen, dtype=torch.int32), 1024)),
    ]
    dist.init_process_group(
        "nccl",
        init_method=f"file://{tmp_path}/store",
        rank=0,
        world_size=1,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        for kern, grid, block, args in cases:
            on_card = tuple(x.to(cuda) if isinstance(x, torch.Tensor) else x for x in args)
            want = kern.launch(grid=grid, block=block, args=on_card, backend="scan")
            got = kern.launch(grid=grid, block=block, args=on_card, mesh=mesh)
            for k in want:
                assert got[k].device.type == "cuda" and torch.equal(got[k], want[k]), (kern.name, k)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# AdamW's multi-tensor kernels (csrc/adamw.cu) against the eager arithmetic
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
# leaves as (elements, parameter dtype, gradient dtype, the tensors that
# start one element past a 16-byte boundary: any of "pgmv")
ADAMW_CASES = {
    # ragged sizes, both dtype groups, leaves off a 16-byte boundary
    "mixed": [
        (3 * 4096 + 5, BF16, BF16, ""),
        (6144, F32, F32, ""),
        (1, BF16, BF16, ""),
        (13, F32, F32, ""),
        (77_777, BF16, BF16, "pgmv"),
        (1000, F32, F32, "g"),
        (8192, BF16, BF16, "m"),
        (2_000_003, BF16, BF16, ""),
    ],
    # a bf16 group of 100 leaves: its table spans two launches
    "many": [(37 * i + 1, BF16, BF16, "") for i in range(100)] + [(100 + i, F32, F32, "") for i in range(3)],
    # grad_compress's group: f32 gradients of bf16 parameters
    "compress": [(50_001, BF16, F32, ""), (6144, F32, F32, ""), (4096, BF16, F32, "v")],
}
ADAMW_LAUNCHES = {"mixed": 2, "many": 3, "compress": 2}


def _adamw_leaves(cuda, leaves, gen):
    """(params, m, v) lists on the card: parameters ~ N(0, 0.02^2), zero
    moments; a tensor named in a leaf's offsets starts one element into
    its buffer."""
    def place(t, off):
        buf = torch.empty(t.numel() + off, dtype=t.dtype, device=cuda)
        out = buf[off:]
        out.copy_(t)
        assert out.is_contiguous() and (out.data_ptr() % 16 != 0) == bool(off)
        return out

    ps, ms, vs = [], [], []
    for n, p_dtype, _, off in leaves:
        ps.append(place((0.02 * torch.randn(n, generator=gen)).to(p_dtype), int("p" in off)))
        ms.append(place(torch.zeros(n), int("m" in off)))
        vs.append(place(torch.zeros(n), int("v" in off)))
    return ps, ms, vs


def _adamw_grads(cuda, leaves, gen):
    """Gradients in each leaf's dtype, their magnitudes spread over three
    decades from leaf to leaf, placed as the leaf's offsets say."""
    out = []
    for i, (n, _, g_dtype, off) in enumerate(leaves):
        g = (10.0 ** (-(i % 4)) * torch.randn(n, generator=gen)).to(g_dtype)
        buf = torch.empty(n + int("g" in off), dtype=g_dtype, device=cuda)
        out.append(buf[int("g" in off) :])
        out[-1].copy_(g)
    return out


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The most units in the last place between two f32 or bf16 tensors."""
    iv = torch.int32 if a.dtype == F32 else torch.int16
    return int((a.contiguous().view(iv).long() - b.contiguous().view(iv).long()).abs().max())


def test_adamw_layout_is_the_librarys(cuda):
    """The library's table is ``build.AdamWTable`` (``layout`` raises
    otherwise), its chunk whole 16-byte units of bf16 and f32, and its
    grids at least one block an SM."""
    lay = padamw.layout()
    assert lay.chunk > 0 and lay.chunk % 8 == 0
    assert lay.sumsq_blocks_per_sm >= 1 and lay.apply_blocks_per_sm >= 1


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_apply_is_bitwise_the_eager_update(cuda, case):
    """Three steps in a row: ``cox_adamw_apply`` gives m, v and the
    parameters bitwise equal to ``apply_plain`` on the card (the eager
    update's arithmetic, each leaf cast to f32 as ``update_eager`` casts
    it), given the same clip scale, learning rate and bias corrections on
    the device; one launch a dtype group of up to ADAMW_MAX_LEAVES."""
    leaves = ADAMW_CASES[case]
    gen = torch.Generator().manual_seed(7)
    ps, ms, vs = _adamw_leaves(cuda, leaves, gen)
    pe, me, ve = ([t.clone() for t in ts] for ts in (ps, ms, vs))
    launch_plan = padamw.plan([(n, pd, gd) for n, pd, gd, _ in leaves], padamw.layout().chunk)
    assert len(launch_plan) == ADAMW_LAUNCHES[case]
    cfg = poptim.AdamWConfig(lr=1e-2, warmup_steps=2)
    hyper = poptim._hyper(cfg)
    for step in (1, 2, 3):
        gs = _adamw_grads(cuda, leaves, gen)
        t = torch.tensor(step, dtype=torch.int32, device=cuda).to(F32)
        scale = torch.tensor(0.37 + 0.2 * step, device=cuda).clamp(max=1.0)
        lr = poptim.schedule(cfg, torch.tensor(step, dtype=torch.int32, device=cuda))
        b1c, b2c = 1 - torch.pow(0.9, t), 1 - torch.pow(0.95, t)
        before = padamw.apply_launches
        padamw.apply_cuda(launch_plan, ps, gs, ms, vs, scale.reshape(()), lr, b1c, b2c, **hyper)
        assert padamw.apply_launches - before == ADAMW_LAUNCHES[case]
        for p, m, v, g in zip(pe, me, ve, gs):
            p.copy_(padamw.apply_plain(p.float(), m, v, g.float(), scale, lr, b1c, b2c, **hyper).to(p.dtype))
        torch.cuda.synchronize()
        for i in range(len(leaves)):
            for what, got, want in (("m", ms[i], me[i]), ("v", vs[i], ve[i]), ("p", ps[i], pe[i])):
                assert torch.equal(got, want), (case, step, i, leaves[i], what, _ulps(got, want))


def test_adamw_global_norm_is_repeatable_and_matches_the_eager_norm(cuda):
    """``cox_adamw_sumsq`` and the finalising block: the norm of bf16 and
    f32 gradients (a group of 2^25 + 3 elements among them) within 2e-6 of
    the eager norm, bitwise the same twice; the clip scale bitwise the
    eager formula's on that norm, for a clip that engages, one that does
    not, and none (scale 1)."""
    leaves = ADAMW_CASES["mixed"] + [(2**25 + 3, BF16, BF16, "")]
    gen = torch.Generator().manual_seed(3)
    gs = _adamw_grads(cuda, leaves, gen)
    launch_plan = padamw.plan([(n, pd, gd) for n, pd, gd, _ in leaves], padamw.layout().chunk)
    before = padamw.launches
    got = padamw.global_norm_cuda(gs, launch_plan, 1.0)
    assert padamw.launches - before == 2
    assert torch.equal(got, padamw.global_norm_cuda(gs, launch_plan, 1.0))
    eager = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    f64 = float(torch.sqrt(sum(torch.sum(torch.square(g.double())) for g in gs)))
    norm = float(got[0])
    assert abs(norm - float(eager)) <= 2e-6 * float(eager), (norm, float(eager), f64)
    assert norm > 10.0
    for clip in (1.0, 1e6, 0.0):
        out = padamw.global_norm_cuda(gs, launch_plan, clip)
        want = torch.clamp(clip / torch.clamp(out[0], min=1e-12), max=1.0) if clip else torch.ones((), device=cuda)
        assert torch.equal(out[1], want), (clip, float(out[1]), float(want))


@pytest.mark.parametrize("grad_compress", [False, True])
def test_adamw_update_on_the_card_neither_syncs_nor_allocates_a_leaf(cuda, grad_compress):
    """``adamw.update`` on plain CUDA leaves runs under
    ``set_sync_debug_mode("error")`` (no host sync), launches each kernel
    once a dtype group, allocates nothing near a leaf's width (without
    ``grad_compress``, whose int8 round trip is eager) and agrees with
    ``update_eager``: the norm within 2e-6, the moments within 1e-5
    (their clip scales round apart), the parameters within a bf16 step."""
    from repro_torch.models.params import tree_leaves, tree_map

    cfg = poptim.AdamWConfig(lr=1e-2, warmup_steps=2, grad_compress=grad_compress)
    gen = torch.Generator().manual_seed(5)

    def tree(scale):
        return {
            "w": (scale * torch.randn(1024, 4096, generator=gen)).to(BF16).to(cuda),
            "n": {"w": torch.randn(4096, generator=gen).to(cuda)},
            "z": (scale * torch.randn(3, 1001, generator=gen)).to(BF16).to(cuda),
        }

    params = tree(0.02)
    twin = tree_map(torch.clone, params)
    st, st2 = poptim.init_state(params, cfg), poptim.init_state(twin, cfg)
    for _ in range(3):
        grads = tree(1.0)
        before = ops.launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, st, met = poptim.update(grads, st, params, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        peak = torch.cuda.max_memory_allocated() - base
        after = ops.launch_counts()
        assert (after["adamw_sumsq"] - before["adamw_sumsq"], after["adamw_apply"] - before["adamw_apply"]) == (2, 2)
        if not grad_compress:
            assert peak < 2**20, peak  # the largest leaf in f32: 16 MiB
        twin, st2, met2 = poptim.update_eager(grads, st2, twin, cfg)
        gn, gn2 = float(met["grad_norm"]), float(met2["grad_norm"])
        assert abs(gn - gn2) <= 2e-6 * gn2, (gn, gn2)
        assert torch.equal(met["lr"], met2["lr"])
        for k in ("m", "v"):
            for a, b in zip(tree_leaves(st[k]), tree_leaves(st2[k])):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-12)
        for a, b in zip(tree_leaves(params), tree_leaves(twin)):
            torch.testing.assert_close(a.float(), b.float(), rtol=2**-7, atol=1e-6)


def test_adamw_update_refuses_leaves_the_kernels_do_not_take(cuda):
    """A leaf that is not contiguous, and dtypes the kernels lack (an f16
    parameter, an f64 gradient), raise before any launch."""
    cfg = poptim.AdamWConfig()
    cases = [
        (torch.randn(64, 32, device=cuda).t(), torch.randn(32, 64, device=cuda), ValueError, "contiguous"),
        (torch.randn(64, device=cuda, dtype=torch.float16), torch.randn(64, device=cuda, dtype=torch.float16), TypeError, "dtype"),
        (torch.randn(64, device=cuda), torch.randn(64, device=cuda, dtype=torch.float64), TypeError, "dtype"),
    ]
    for p, g, err, match in cases:
        params = {"a": torch.randn(8, device=cuda), "b": p}
        st = poptim.init_state(params, cfg)
        before = ops.launch_counts()
        with pytest.raises(err, match=match):
            poptim.update({"a": torch.randn(8, device=cuda), "b": g}, st, params, cfg)
        assert ops.launch_counts() == before


def test_held_experts_on_the_card(cuda):
    """granite-4.0-h's MoE at its widths (d 4,096, 72 experts of 768, top
    10, 9 held): the card's bf16 layer against the same layer in f32 on
    the same bf16 values, forward and backward, the router's f32 logits
    shared, and the same bits twice."""
    import dataclasses

    from repro_torch.configs import granite_4_0_h_small
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(granite_4_0_h_small.CONFIG, experts_held=9, shared_intermediate_size=0)
    p = init_params(L.moe_specs(cfg), torch.Generator(device=cuda).manual_seed(11), cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    xt = torch.randn(2048, cfg.d_model, generator=gen, device=cuda).to(torch.bfloat16)
    dy = torch.randn(2048, cfg.d_model, generator=gen, device=cuda).to(torch.bfloat16)

    def run(params, x):
        params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        x = x.detach().requires_grad_(True)
        y = L.moe_held(params, x, cfg=cfg)
        return y, torch.autograd.grad(y, [x, params["w_gate"], params["w_up"], params["w_down"], params["router"]],
                                      dy.to(y.dtype))

    got, grads = run(p, xt)
    again, _ = run(p, xt)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    f32 = {k: v.float() for k, v in p.items()}
    want, want_grads = run(f32, xt.float())
    _close_to_scale(got, want, 2.0**-7, 1e-2, "y")
    for name, g, w in zip(("dx", "dw_gate", "dw_up", "dw_down", "drouter"), grads, want_grads):
        _close_to_scale(g, w, 2.0**-6, 2e-2, name)
