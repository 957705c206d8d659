"""The dry run and its counted cost (ROADMAP A.10.3): the port's
``launch/hlo_analysis.py`` and ``launch/dryrun.py`` against the
reference's.

The cases of ``tests/test_hlo_analysis.py``, in the port's terms:

* :36 (the scan-corrected flops equal the unrolled compile's): the port
  runs its layers as a Python loop, so every layer is counted as it runs;
  its matmul flops for qwen2.5-14b-smoke at 4 layers, ``remat="none"``,
  equal the reference's ``analyze(...)["flops"]`` of the same forward
  within 1 %, and each added layer adds the same count;
* :52 (the raw count undercounts a scan): counting one layer once, as
  XLA's raw ``cost_analysis`` counts a scanned body, would miss most of
  the 4-layer count;
* :62 and :78 (dot operands printed with and without inline types): these
  test the reference's HLO text parser, which the port has no counterpart
  of; in their place, the count of a plain product, of the products under
  ``einsum`` and ``bmm``, and of a DTensor product (rank 0's shard only).

And ``tests/test_system.py::test_dryrun_single_cell_smoke`` (:73): the
granite smoke train cell on a (1, 1) mesh counts positive flops and
non-negative temp bytes.  The dry run proper runs in a subprocess
(``tests/torch_dryrun_worker.py``, its own timeout): ``run_cell`` over a
fake 16 x 16 world returns ``ok`` for one smoke config of each of the six
families, and the argument bytes a rank of a (2, 2) train cell equal the
reference's ``memory_analysis().argument_size_in_bytes`` on 4 host
devices, byte for byte.  A ``meta`` tensor takes every kernel's plain
version and launches nothing.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.hlo_analysis import analyze as janalyze
from repro.models import lm as jlm
from repro.models.params import tree_abstract
from repro_torch.configs import registry as preg
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis as H
from repro_torch.models import lm as plm
from repro_torch.models.params import init_params
from torch_suite import one_rank_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = str(pathlib.Path(__file__).with_name("torch_dryrun_worker.py"))
SPAWN_TIMEOUT_S = 240


def _port_flops(n_layers: int) -> float:
    cfg = dataclasses.replace(preg.get("qwen2.5-14b", smoke=True), n_layers=n_layers, remat="none")
    params = init_params(plm.lm_specs(cfg), None, "meta")
    batch = {k: torch.zeros(2, 128, dtype=torch.int32, device="meta") for k in ("tokens", "labels")}
    return H.analyze(plm.forward, cfg, params, batch)["flops"]


def test_loop_counted_flops_match_the_reference():
    """tests/test_hlo_analysis.py:36: the port's matmul flops of the
    4-layer forward equal the reference's while-aware ``analyze`` of its
    compiled forward within 1 %, and the loop adds one layer's count a
    layer (the count at 4 layers minus 2 is twice 2 minus 1, exactly)."""
    cfg = dataclasses.replace(jreg.get("qwen2.5-14b", smoke=True), n_layers=4, remat="none")
    batch = {k: jax.ShapeDtypeStruct((2, 128), jnp.int32) for k in ("tokens", "labels")}
    compiled = jax.jit(lambda p, b: jlm.forward(cfg, p, b, backend="xla")[0]).lower(
        tree_abstract(jlm.lm_specs(cfg)), batch
    ).compile()
    want = janalyze(compiled.as_text())["flops"]
    f1, f2, f4 = (_port_flops(n) for n in (1, 2, 4))
    assert abs(f4 - want) <= 0.01 * want, (f4, want)
    assert f4 - f2 == 2 * (f2 - f1) > 0


def test_one_layer_counted_once_would_undercount():
    """tests/test_hlo_analysis.py:52: the undercount the reference's
    analyzer exists to fix (4 scanned layers counted once) is large; the
    port, which counts every layer, is over 1.5 x that."""
    f1, f4 = _port_flops(1), _port_flops(4)
    assert f4 > 1.5 * f1


def test_matmul_flops_of_a_plain_product():
    """In place of tests/test_hlo_analysis.py:62 (an HLO operand printed
    as a bare name): a (8, 16) x (16, 32) product counts 2 * 8 * 32 * 16
    flops, as the reference's dot rule does, and its output bytes twice."""
    x, y = torch.zeros(8, 16), torch.zeros(16, 32)
    got = H.analyze(torch.matmul, x, y)
    assert got["flops"] == 2 * 8 * 32 * 16
    assert got["out_bytes"] == 2 * 8 * 32 * 4 and got["coll_bytes"] == 0


def test_matmul_flops_through_einsum_bmm_and_a_dtensor():
    """In place of tests/test_hlo_analysis.py:78 (both operands with
    inline types): the products under ``einsum`` and a batched product
    count 2 * M * N * K each, on ``meta`` tensors too; a DTensor product
    counts this rank's shard's product (not DTensor's propagation of its
    sharding), a functional all-gather its result bytes and an in-place
    all-reduce its tensor's."""
    q = torch.zeros(2, 8, 4, 16, device="meta")
    got = H.analyze(lambda q: torch.einsum("bshd,bthd->bhst", q, q), q)
    assert got["flops"] == 2 * (2 * 4) * 8 * 8 * 16
    a, b = torch.zeros(3, 8, 16), torch.zeros(3, 16, 4)
    assert H.analyze(torch.bmm, a, b)["flops"] == 2 * 3 * 8 * 4 * 16
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with one_rank_mesh(("data", "model")) as mesh:
        x = DTensor.from_local(torch.zeros(8, 16), mesh, (Shard(0), Replicate()))
        w = DTensor.from_local(torch.zeros(16, 32), mesh, (Replicate(), Shard(1)))
        assert H.analyze(lambda x, w: x @ w, x, w)["flops"] == 2 * 8 * 32 * 16

        def comms(t):
            funcol.all_gather_tensor(t, 0, mesh.get_group("model")).wait()
            dist.all_reduce(t.clone(), group=mesh.get_group("model"))

        got = H.analyze(comms, torch.zeros(8, 32))
    assert got["coll.all-gather"] == got["coll.all-reduce"] == 8 * 32 * 4
    assert got["coll_bytes"] == 2 * 8 * 32 * 4


def test_meta_tensors_take_the_plain_versions():
    """A ``meta`` tensor (the dry run's) resolves to ``"meta"`` and takes
    every kernel's plain version for its shapes alone: the right shapes
    and dtypes come back and no kernel launches."""
    ops.reset_launch_counts()
    m = "meta"
    x = torch.zeros(4, 64, device=m, dtype=torch.bfloat16)
    w = torch.zeros(64, device=m)
    assert ops.resolve(x) == "meta"
    assert ops.softmax(x).shape == x.shape and ops.row_reduce(x).dtype == torch.float32
    assert ops.rmsnorm(x, w).shape == x.shape and ops.layernorm(x, w, w).dtype == x.dtype
    q = torch.zeros(2, 8, 4, 16, device=m)
    assert ops.attention(q, q[:, :, :2], q[:, :, :2]).shape == q.shape
    kv = torch.zeros(2, 12, 2, 16, device=m)
    out, lse = ops.decode_attention(q[:, 0], kv, kv, torch.zeros(2, dtype=torch.int32, device=m), return_lse=True)
    assert out.shape == (2, 4, 16) and lse.shape == (2, 4)
    xs = torch.zeros(2, 256, 3, 8, device=m)
    y = ops.ssd_scan(xs, xs[..., 0], torch.zeros(2, 256, 5, device=m), torch.zeros(2, 256, 5, device=m), chunk=128)
    assert y.shape == xs.shape
    assert all(n == 0 for n in ops.launch_counts().values())


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """The port's dry-run process and the reference's 4-device compile,
    started together; ``(port record, reference record)``."""
    d = tmp_path_factory.mktemp("dryrun")
    procs = [
        ("port", _env()),
        ("ref", _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")),
    ]
    running = []
    for what, env in procs:
        log = open(d / f"{what}.log", "w+")
        cmd = [sys.executable, WORKER, what, "--out", str(d)]
        running.append((what, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    failures = []
    for what, p, log in running:
        try:
            rc = p.wait(timeout=SPAWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, q, _ in running:
                q.kill()
            rc = "timeout"
        if rc != 0:
            log.seek(0)
            failures.append(f"{what} ({rc}):\n{log.read()[-3000:]}")
        log.close()
    assert not failures, "\n".join(failures)
    return json.loads((d / "port.json").read_text()), json.loads((d / "ref.json").read_text())


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "vlm", "encdec"])
def test_run_cell_on_a_fake_16x16_world(dry, family):
    """``run_cell`` of one smoke config of each family (train_4k) on the
    fake 16 x 16 production mesh: ``ok``, with positive flops, collective
    bytes and argument bytes, and the counted temp bytes."""
    rec = dry[0]["families"][family]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["mesh"] == "16x16"
    assert rec["flops"] > 0 and rec["coll_bytes"] > 0 and rec["argument_size"] > 0
    assert rec["temp_size_counted"] > 0 and rec["collectives"]["count"] > 0


def test_argument_bytes_a_rank_equal_the_references(dry):
    """The qwen smoke train_4k cell on (2, 2): the argument bytes of rank
    0 (its shards of the parameters, the ZeRO-1 moments, the step counter
    and the batch) equal the reference's
    ``memory_analysis().argument_size_in_bytes`` on 4 XLA host devices,
    byte for byte."""
    port, ref = dry
    rec = port["args_cell"]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["argument_size"] == ref["argument_size"]


def test_dryrun_single_cell_smoke(dry):
    """tests/test_system.py:73: the granite smoke train cell on a (1, 1)
    mesh runs, with positive flops and non-negative temp bytes."""
    rec = dry[0]["single"]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["mesh"] == "1x1" and rec["flops"] > 0 and rec["temp_size_counted"] >= 0
