"""The port's stream placement against the JAX package's.

The six one-device cases of ``tests/test_placement.py``
(priorities ordering the ready set, program order beating priority, the
legacy path of a one-device pool, the explicit pin, ``device=`` against
``mesh=``, the per-device sticky error and its scoped reset) run on
both packages with the same dispatch orders and counters.  The three
policies are ported whole: their ``pick`` runs on device stand-ins and
a stub dispatcher's health counters, next to the reference's policies on
the same stand-ins.  The four multi-device cases of the reference's
file run over four logical devices on the host in
``tests/test_torch_multidevice.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import placement as rplacement
from repro_torch.core import cox as pcox
from repro_torch.core import placement
from repro_torch.core.streams import Dispatcher
from torch_suite import SIDES, annot, define, on_both


def _prio_add(c, out, x, n):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = x[i] + 1.0


PRIO_ADD = define(_prio_add, annot(out="f", x="f", n="n"))
CPU = torch.device("cpu")


def _req(side, n=256):
    x = np.arange(n, dtype=np.float32)
    return side.k(PRIO_ADD).make_request(grid=1, block=n, args=(np.zeros(n, np.float32), x, n))


def test_priority_orders_ready_set():
    def scenario(side):
        d = side.dispatcher()
        lo = side.cox.Stream("lo", dispatcher=d, priority=5)
        hi = side.cox.Stream("hi", dispatcher=d, priority=-5)
        mid = side.cox.Stream("mid", dispatcher=d)
        hs = [d.enqueue(_req(side), lo), d.enqueue(_req(side), mid), d.enqueue(_req(side), hi)]
        d.flush()
        outs = [np.asarray(h.result()["out"]) for h in hs]
        seqs = {h.request.seq: h.stream.name for h in hs}
        order = [seqs[s] for s in d.dispatch_log if s in seqs]
        return order, [h.request.priority for h in hs], outs

    (ro, rp, routs), (po, pp, pouts) = on_both(scenario)
    assert po == ro == ["hi", "mid", "lo"]
    assert pp == rp == [5, 0, -5]
    for p, r in zip(pouts, routs):
        np.testing.assert_array_equal(p, r)


def test_program_order_beats_priority_within_stream():
    def scenario(side):
        d = side.dispatcher()
        lo = side.cox.Stream("lo2", dispatcher=d, priority=5)
        hi = side.cox.Stream("hi2", dispatcher=d, priority=-5)
        hs = (d.enqueue(_req(side), lo), d.enqueue(_req(side), lo), d.enqueue(_req(side), hi))
        d.flush()
        for h in hs:
            h.result()
        pos = {h.request.seq: i for i, h in enumerate(hs)}
        return [pos[s] for s in d.dispatch_log if s in pos]

    ref, port = on_both(scenario)
    assert port == ref
    assert port.index(0) < port.index(1) and port[0] == 2


def test_single_device_pool_is_legacy_path():
    """One device in the pool: no placement; the request's device stays
    None, and so does the stage key's device slot."""
    d = Dispatcher(devices=[CPU])
    assert d.devices == (CPU,)
    s = pcox.Stream("solo", dispatcher=d)
    x = np.arange(256, dtype=np.float32)
    h = s.launch(PRIO_ADD[1], grid=1, block=256, args=(np.zeros(256, np.float32), x, 256))
    np.testing.assert_array_equal(np.asarray(h.result()["out"]), x + 1.0)
    assert h.request.device is None and h.request.target == CPU
    assert h.request.stage_key()[-1] is None
    assert s.device is None


def test_explicit_device_pin_single_pool():
    """An explicit device= runs there, and the staged plan is keyed by
    the device; the port's result is the reference's pinned launch's."""

    def scenario(side):
        dev0 = CPU if side.port else __import__("jax").devices()[0]
        d = side.dispatcher()
        s = side.cox.Stream("pin", dispatcher=d, device=dev0)
        x = np.arange(256, dtype=np.float32)
        h = s.launch(side.k(PRIO_ADD), grid=1, block=256, args=(np.zeros(256, np.float32), x, 256))
        out = np.asarray(h.result()["out"])
        assert h.request.device is dev0 or h.request.device == dev0
        key = h.request.stage_key()[-1]
        assert key == (str(dev0) if side.port else dev0.id)
        np.testing.assert_array_equal(out, x + 1.0)
        return out

    ref, port = on_both(scenario)
    np.testing.assert_array_equal(port, ref)


def test_device_and_mesh_are_mutually_exclusive():
    for side in SIDES:
        dev = CPU if side.port else __import__("jax").devices()[0]
        mesh = object() if side.port else __import__("jax").make_mesh((1,), ("data",))
        with pytest.raises(side.cox.CoxUnsupported, match="mutually exclusive"):
            side.k(PRIO_ADD).make_request(
                grid=1,
                block=256,
                args=(np.zeros(256, np.float32), np.arange(256, dtype=np.float32), 256),
                device=dev,
                mesh=mesh,
            )


def test_per_device_sticky_scoped_and_reset():
    """A sticky fault on a pinned launch poisons that device, blocks the
    (exhausted) pool, and device_reset(device=...) restores it."""

    def scenario(side):
        dev0 = CPU if side.port else __import__("jax").devices()[0]
        d = side.dispatcher()
        s = side.cox.Stream("sick", dispatcher=d, device=dev0)
        x = np.arange(256, dtype=np.float32)
        arr = (np.zeros(256, np.float32), x, 256)
        with side.faults.inject("_prio_add", site="sticky-device", times=1):
            h = s.launch(side.k(PRIO_ADD), grid=1, block=256, args=arr)
            with pytest.raises(side.errors.CoxDeviceError):
                h.result()
        assert list(d.health()["sticky_devices"]) == [str(dev0)]
        s2 = side.cox.Stream("after", dispatcher=d)
        with pytest.raises(side.errors.CoxDeviceError):
            s2.launch(side.k(PRIO_ADD), grid=1, block=256, args=arr)
        d.device_reset(device=dev0)
        assert d.health()["sticky_devices"] == {}
        out = np.asarray(s2.launch(side.k(PRIO_ADD), grid=1, block=256, args=arr).result()["out"])
        np.testing.assert_array_equal(out, x + 1.0)
        return out

    ref, port = on_both(scenario)
    np.testing.assert_array_equal(port, ref)


# ---------------------------------------------------------------------------
# the policies on stand-ins, and the multi-device refusal
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Dev:
    """A device stand-in: the reference's policies read ``.id``, both
    packages' ``str()`` keys the health counters."""

    id: int

    def __str__(self):
        return f"dev{self.id}"


@dataclasses.dataclass
class _Stream:
    _device: object = None


@dataclasses.dataclass
class _Req:
    stream: object = None
    globals_: dict = None


class _Disp:
    def __init__(self, health):
        self._health = health

    def device_health(self):
        return self._health


POOL = [Dev(0), Dev(1), Dev(2)]


@pytest.mark.parametrize("policy", ["RoundRobinPlacement", "HealthAwarePlacement"])
def test_policy_picks_match_the_reference(policy):
    health = {"dev0": {"failures": 2, "degradations": 0}, "dev2": {"failures": 0, "degradations": 1}}
    picks = []
    for mod in (rplacement, placement):
        pol = getattr(mod, policy)()
        disp = _Disp(health)
        streams = [_Stream() for _ in range(5)]
        got = [pol.place(_Req(stream=s, globals_={}), POOL, disp) for s in streams]
        # affinity: a stream keeps its device while it stays healthy...
        again = [pol.place(_Req(stream=s, globals_={}), POOL, disp) for s in streams]
        assert again == got
        # ...and is re-placed among the survivors once it is not
        moved = pol.place(_Req(stream=streams[0], globals_={}), [d for d in POOL if d != got[0]], disp)
        assert moved != got[0]
        picks.append((got, moved))
    assert picks[1] == picks[0]
    if policy == "HealthAwarePlacement":
        assert set(picks[1][0]) == {Dev(1)}  # the only clean device


def test_affinity_placement_follows_the_tensors():
    pool = [CPU, torch.device("meta")]
    pol = placement.AffinityPlacement()
    on_meta = {"a": torch.empty(4, device="meta"), "b": torch.empty(2, device="meta"), "c": torch.zeros(3)}
    assert pol.place(_Req(stream=_Stream(), globals_=on_meta), pool, _Disp({})) == pool[1]
    on_host = {"a": np.zeros(4), "b": torch.zeros(2)}
    assert pol.place(_Req(stream=_Stream(), globals_=on_host), pool, _Disp({})) == CPU
    # no tensor: round-robin
    picks = [pol.place(_Req(stream=_Stream(), globals_={"a": np.zeros(1)}), pool, _Disp({})) for _ in range(2)]
    assert picks == pool
    assert placement.resident_device(torch.zeros(1)) == CPU
    assert placement.resident_device(np.zeros(1)) is None


def test_multi_device_pool_waits_for_a10():
    """A pool is explicit: ``device_pool(n)`` is the first ``n`` real
    devices and raises beyond them, unless logical devices sharing them
    are asked for by name; a pool naming one device twice is refused."""
    from repro_torch.core.runtime import LogicalDevice
    from repro_torch.launch.mesh import device_pool

    assert device_pool(1, device_type="cpu") == (CPU,)
    with pytest.raises(ValueError, match="logical=True"):
        device_pool(4, device_type="cpu")
    pool = device_pool(4, logical=True, device_type="cpu")
    assert pool == tuple(LogicalDevice(i, CPU) for i in range(4))
    assert len({str(d) for d in pool}) == 4
    assert Dispatcher(devices=pool).devices == pool
    assert Dispatcher(devices=[CPU]).devices == (CPU,)
    with pytest.raises(ValueError, match="twice"):
        Dispatcher(devices=[CPU, CPU])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_pool(1)
