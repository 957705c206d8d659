"""The port's checkpointing (``repro_torch.checkpoint.ckpt``) and the
trainer's checkpoint and restart, on the CPU: the checkpoint cases of
``tests/test_substrates.py`` on the port, checkpoints that cross between
the two packages bit for bit, the snapshot of an asynchronous save, and
the failure drill held bitwise against an uninterrupted run.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JaxCheckpointManager
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.ft.watchdog import FailureInjector, retry_loop
from repro_torch.launch import train as ptrain
from repro_torch.models.params import ParamSpec, tree_leaves, tree_map


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {
            "c": torch.randn(2, 5, generator=g).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32),
        },
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as int16), for bitwise comparison."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _specs(tree):
    return tree_map(lambda t: ParamSpec(tuple(t.shape), t.dtype), tree)


def assert_bitwise(got_tree, want_tree):
    assert set(got_tree) == set(want_tree)
    for g, w in zip(tree_leaves(got_tree), tree_leaves(want_tree), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("like", ["tensors", "specs"])
def test_roundtrip_f32_bf16_and_int_leaves(tmp_path, like):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(5, tree, blocking=True)
    assert mgr.latest_step() == 5
    back = mgr.restore(5, tree if like == "tensors" else _specs(tree), "cpu")
    assert_bitwise(back, tree)
    names = sorted(os.listdir(tmp_path / "step_00000005"))
    assert names == ["a.npy", "b__c.npy", "b__step.npy", "manifest.json"]
    [save, restore] = mgr.log
    assert save["op"] == "save" and save["bytes"] == 12 * 4 + 10 * 2 + 4
    assert restore["op"] == "restore" and restore["bytes"] == save["bytes"]


def test_atomic_commit_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((4,), float(s))}, blocking=True)
    entries = sorted(os.listdir(tmp_path))
    assert entries == ["LATEST", "step_00000003", "step_00000004"]  # no .tmp left
    assert (tmp_path / "LATEST").read_text() == "step_00000004"
    assert mgr.latest_step() == 4
    back = mgr.restore(3, {"x": ParamSpec((4,), torch.float32)}, "cpu")
    assert torch.equal(back["x"], torch.full((4,), 3.0))
    with pytest.raises(ValueError, match="arch mismatch"):
        mgr.restore(4, {"x": ParamSpec((5,), torch.float32)}, "cpu")


def test_an_unfinished_save_is_not_the_latest(tmp_path):
    """A crash mid-save leaves a ``.tmp`` directory and the pointer at the
    last complete step."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(2)}, blocking=True)
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert mgr.latest_step() == 1
    mgr.save(2, {"x": torch.ones(2)}, blocking=True)  # the stale .tmp is replaced
    assert mgr.latest_step() == 2 and not (tmp_path / "step_00000002.tmp").exists()


def test_restore_checks_dtype_and_device(tmp_path):
    """In place of the reference's elastic resharding: a restore places
    every leaf on the device it is given, and refuses a model whose dtype
    differs from the checkpoint's."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"x": torch.arange(16, dtype=torch.float32)}, blocking=True)
    back = mgr.restore(0, {"x": ParamSpec((16,), torch.float32)}, torch.device("cpu"))
    assert back["x"].device.type == "cpu"
    with pytest.raises(ValueError, match="float32 vs model bfloat16"):
        mgr.restore(0, {"x": ParamSpec((16,), torch.bfloat16)}, "cpu")


@pytest.mark.cuda
def test_restore_onto_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(0, tree, blocking=True)
    back = mgr.restore(0, _specs(tree))  # the card by default
    assert all(t.device.type == "cuda" for t in tree_leaves(back))
    assert_bitwise(tree_map(lambda t: t.cpu(), back), tree)


def test_missing_leaf_and_corrupt_shape_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"x": torch.zeros(4)}, blocking=True)
    with pytest.raises(KeyError, match="missing leaf y"):
        mgr.restore(3, {"x": torch.zeros(4), "y": torch.zeros(1)}, "cpu")
    np.save(tmp_path / "step_00000003" / "x.npy", np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="corrupt leaf x"):
        mgr.restore(3, {"x": torch.zeros(4)}, "cpu")


def test_retry_loop_restarts_from_the_latest_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(9, {"x": torch.zeros(1)}, blocking=True)
    calls = []

    def run_from(start):
        calls.append(start)
        if len(calls) == 1:
            raise RuntimeError("injected node failure")
        return 99

    assert retry_loop(run_from, ckpt_mgr=mgr) == 99
    assert calls == [10, 10]  # resumed from the latest checkpoint both times


def test_an_async_save_keeps_the_values_it_was_given(tmp_path, monkeypatch):
    """The trainer updates its tensors in place right after ``save``
    returns; the checkpoint still holds the values at the call.  The
    background write is held until the tensors have changed."""
    gate, write = threading.Event(), CheckpointManager._write

    def held_write(self, *args):
        gate.wait()
        write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    mgr = CheckpointManager(str(tmp_path))
    x = torch.arange(1 << 16, dtype=torch.float32)
    w = torch.ones(1 << 16, dtype=torch.bfloat16)
    mgr.save(1, {"x": x, "w": w})  # asynchronous
    x.mul_(-1)
    w.add_(1)
    gate.set()
    mgr.wait()
    back = mgr.restore(1, {"x": x, "w": w}, "cpu")
    assert torch.equal(back["x"], torch.arange(1 << 16, dtype=torch.float32))
    assert torch.equal(back["w"], torch.ones(1 << 16, dtype=torch.bfloat16))


def test_a_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    g = np.random.default_rng(0)
    tree = {
        "a": jnp.asarray(g.normal(size=(3, 4)).astype(np.float32)),
        "b": {
            "c": jnp.asarray(g.normal(size=(2, 5)), jnp.bfloat16),
            "step": jnp.int32(7),
        },
    }
    JaxCheckpointManager(str(tmp_path)).save(4, tree, blocking=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 4
    like = {
        "a": ParamSpec((3, 4), torch.float32),
        "b": {"c": ParamSpec((2, 5), torch.bfloat16), "step": ParamSpec((), torch.int32)},
    }
    back = mgr.restore(4, like, "cpu")
    assert np.array_equal(back["a"].numpy(), np.asarray(tree["a"]))
    want_c = np.asarray(tree["b"]["c"]).view(np.int16)
    assert np.array_equal(back["b"]["c"].view(torch.int16).numpy(), want_c)
    assert back["b"]["step"].dtype == torch.int32 and int(back["b"]["step"]) == 7


def test_a_port_checkpoint_restores_in_the_jax_package_bitwise(tmp_path):
    tree = _tree(1)
    CheckpointManager(str(tmp_path)).save(6, tree, blocking=True)
    jmgr = JaxCheckpointManager(str(tmp_path))
    assert jmgr.latest_step() == 6
    like = {
        "a": jax.ShapeDtypeStruct((3, 4), jnp.float32),
        "b": {
            "c": jax.ShapeDtypeStruct((2, 5), jnp.bfloat16),
            "step": jax.ShapeDtypeStruct((), jnp.int32),
        },
    }
    back = jmgr.restore(6, like)
    assert np.array_equal(np.asarray(back["a"]), tree["a"].numpy())
    assert back["b"]["c"].dtype == jnp.bfloat16
    got_c = np.asarray(back["b"]["c"]).view(np.int16)
    assert np.array_equal(got_c, tree["b"]["c"].view(torch.int16).numpy())
    assert int(back["b"]["step"]) == 7


def test_train_resumes_after_an_injected_failure(tmp_path):
    """The reference's drill: a crash at step 12 restarts from the
    checkpoint of step 9, steps 10 and 11 run again and their losses are
    appended again."""
    inj = FailureInjector({12: RuntimeError("simulated device loss")})
    out = ptrain.train(
        "mamba2-130m-smoke", steps=16, batch=4, seq=64, ckpt_dir=str(tmp_path),
        ckpt_every=5, injector=inj, log_every=100, device="cpu",
    )
    assert out["final_step"] == 15
    assert len(out["losses"]) >= 16
    assert len(out["losses"]) == 18 and out["losses"][10:12] == out["losses"][12:14]
    assert CheckpointManager(str(tmp_path)).latest_step() == 15
    restores = [r for r in out["ckpt_log"] if r["op"] == "restore"]
    assert [r["step"] for r in restores] == [9]


@pytest.mark.parametrize("arch", ["mamba2-130m-smoke", "seamless-m4t-large-v2-smoke"])
def test_a_resumed_run_equals_an_uninterrupted_one_bitwise(tmp_path, arch):
    """Six steps with a checkpoint every two and a failure before step 4,
    against six steps with neither: the final parameters and moments and
    every step's loss equal bit for bit (the data source is indexed by
    the step, and a restore is exact)."""
    kw = dict(steps=6, batch=2, seq=32, log_every=100, device="cpu")
    inj = FailureInjector({4: RuntimeError("drill")})
    resumed = ptrain.train(arch, ckpt_dir=str(tmp_path), ckpt_every=2, injector=inj, **kw)
    plain = ptrain.train(arch, **kw)
    assert [r["op"] for r in resumed["ckpt_log"]].count("restore") == 1
    assert resumed["losses"] == plain["losses"]
    assert_bitwise(resumed["params"], plain["params"])
    assert_bitwise(resumed["opt"], plain["opt"])
