"""The processes behind ``tests/test_torch_mesh_models.py``.

    python tests/torch_mesh_worker.py ref  --devices N --out DIR
    python tests/torch_mesh_worker.py rank --rank R --world N --out DIR

``ref`` runs the JAX package's side for ``N`` XLA host devices (the caller
sets ``XLA_FLAGS=--xla_force_host_platform_device_count=N``), every mesh
built with Auto axes (ROADMAP C.2); ``rank`` is one gloo rank of the
port's world of ``N``.  Both take their weights from :func:`weights`, a
numpy draw from a seed over each package's spec tree (the same shapes and
key order), and write one ``.npz`` a case to ``DIR``.

World 8, mesh (2, 4): the expert-parallel MoE (``test_multidevice.py``
:85, and with a capacity that drops tokens) and the qwen train step under
``"tp"`` and ``"fsdp"`` (:106) and with ``grad_compress``.  World 4: the
server on (1, 2) and (2, 2) with a prompt that crosses a slab boundary, a
mamba2 train step on (2, 1), a checkpoint saved on (2, 2) and restored on
(1, 2) and without a mesh, and the collectives of one dense layer and one
decode step on (1, 2).  The SSM, hybrid and encoder-decoder families
under "tp": in world 8, f32 decode steps of mamba2 on (1, 2), (1, 4) and
a "model" axis of 3 on which some Mamba2 leaves shard and others
replicate (``MIXED``), zamba2 on (1, 2) and seamless on (1, 2) and
(2, 2); in world 4, train steps of all three on (2, 2) and of the mixed
mamba2 on (1, 3), the server on (1, 2) for mamba2 and seamless, their
checkpoints saved on (2, 2) and restored on (1, 2) and without a mesh,
and deepseek's MoE with its experts replicated on (1, 3).
"""

import argparse
import dataclasses
import datetime
import pathlib
import sys
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

QWEN = "qwen2.5-14b-smoke"
MOE = "granite-moe-1b-a400m-smoke"  # 4 experts
MOE_SHARED = "deepseek-moe-16b-smoke"  # 4 experts and a shared one
MAMBA = "mamba2-130m-smoke"
TRAIN_SHAPE = ("t", 64, 4, "train")  # test_multidevice.py:106
OPT = dict(lr=1e-2, warmup_steps=0, eps=1e-2)  # smooth first steps (ROADMAP C.4)
SERVE = dict(batch=4, ctx=24)
PROMPTS = [list(range(5, 19)), [1, 2], [40, 41, 42]]  # 14 tokens cross the slab at 12
DECODE_TOKENS = 8
MOE_X = (4, 8)  # (B, S) of test_multidevice.py:85
ZAMBA = "zamba2-1.2b-smoke"
SEAMLESS = "seamless-m4t-large-v2-smoke"
# on a "model" axis of 3: w_in (230 columns) and conv (128) replicated,
# the 6 SSM heads (h), norm and w_out (96) sharded
MIXED = dict(d_model=48, ssm_inner=96, ssm_heads=6)
DECODE = dict(batch=4, ctx=24, tokens=[3, 4, 5, 6], pos=[0, 5, 13, 23])
# (case, arch, mesh, config overrides)
DECODE_CASES = [
    ("dec_mamba_12", MAMBA, (1, 2), {}),
    ("dec_mamba_14", MAMBA, (1, 4), {}),
    ("dec_mamba_13", MAMBA, (1, 3), MIXED),
    ("dec_zamba_12", ZAMBA, (1, 2), {}),
    ("dec_seamless_12", SEAMLESS, (1, 2), {}),
    ("dec_seamless_22", SEAMLESS, (2, 2), {}),
]
TP_TRAIN_CASES = [
    ("ttp_mamba", MAMBA, (2, 2), {}),
    ("ttp_zamba", ZAMBA, (2, 2), {}),
    ("ttp_seamless", SEAMLESS, (2, 2), {}),
    ("ttp_mamba_13", MAMBA, (1, 3), MIXED),
]
TP_SERVE_CASES = [("serve_mamba_12", MAMBA, (1, 2)), ("serve_seamless_12", SEAMLESS, (1, 2))]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def weights(spec_tree, seed: int) -> dict:
    """Numpy f32 weights for a spec tree (either package's): ones-inits
    near 1, zeros-inits small, the rest N(0, 0.02), drawn leaf by leaf in
    sorted path order."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in _leaves(spec_tree):
        shape = tuple(s.shape)
        if s.init == "ones":
            a = 1 + 0.1 * rng.normal(size=shape)
        elif s.init == "zeros":
            a = 0.1 * rng.normal(size=shape)
        else:
            a = 0.02 * rng.normal(size=shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(np.float32)
    return out


def flat(tree, prefix: str = "") -> dict:
    return {prefix + "/".join(p): np.asarray(v) for p, v in _leaves(tree)}


def moe_x(cfg):
    return np.random.default_rng(2).normal(size=MOE_X + (cfg.d_model,)).astype(np.float32)


# ---------------------------------------------------------------------------
# the JAX package
# ---------------------------------------------------------------------------


def ref_main(devices: int, out: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import registry
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import DataConfig, TokenSource
    from repro.launch import serve
    from repro.models import layers as L
    from repro.models.params import default_rules
    from repro.optim import adamw
    from repro.parallel import steps

    assert len(jax.devices()) == devices

    def mesh(shape):
        n = shape[0] * shape[1]
        devs = np.array(jax.devices()[:n]).reshape(shape)
        return jax.sharding.Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)

    def f32(arch, **kw):
        return dataclasses.replace(registry.get(arch), param_dtype=jnp.float32, **kw)

    def train(case, cfg, m, strategy="tp", compress=False):
        shape = ShapeConfig(*TRAIN_SHAPE)
        opt_cfg = adamw.AdamWConfig(grad_compress=compress, **OPT)
        jitted, bundle, _ = steps.jit_train_step(cfg, m, shape, opt_cfg=opt_cfg, strategy=strategy)
        params = jax.device_put(
            jax.tree_util.tree_map(jnp.asarray, weights(bundle["specs"], 0)), bundle["param_sh"]
        )
        opt = jax.device_put(adamw.init_state(params, opt_cfg), bundle["opt_sh"])
        batch = {k: jnp.asarray(v) for k, v in TokenSource(cfg, shape, DataConfig()).batch_at(0).items()}
        params, opt, metrics = jitted(params, opt, batch)
        np.savez(
            out / f"{case}.ref.npz",
            loss=np.asarray(metrics["loss"]),
            grad_norm=np.asarray(metrics["grad_norm"]),
            **flat(jax.tree_util.tree_map(np.asarray, params), "p/"),
        )

    def serve_tokens(arch, cfg, m):
        params = jax.tree_util.tree_map(jnp.asarray, weights(steps.model_specs(cfg), 3))
        server = serve.BatchedServer(arch, mesh=m, params=params, **SERVE)
        for slot, prompt in enumerate(PROMPTS):
            server.prefill_prompt(slot, prompt)
        outs = server.decode(DECODE_TOKENS)
        return np.array([o + [-1] * (DECODE_TOKENS - len(o)) for o in outs])

    if devices == 8:
        m = mesh((2, 4))
        for case, cf in (("moe_ep", None), ("moe_drop", 0.5)):
            cfg = f32(MOE) if cf is None else f32(MOE, capacity_factor=cf)
            p = jax.tree_util.tree_map(jnp.asarray, weights(L.moe_specs(cfg), 1))
            x = jnp.asarray(moe_x(cfg))
            got = L.moe_apply(p, x, cfg=cfg, rules=default_rules(m))
            np.savez(out / f"{case}.ref.npz", y=np.asarray(got))
        for case, strategy, compress in (("train_tp", "tp", False), ("train_fsdp", "fsdp", False), ("train_compress", "tp", True)):
            train(case, f32(QWEN), m, strategy, compress)
        from repro.launch import specs as S
        from repro.models import encdec, lm

        for case, arch, shape, over in DECODE_CASES:
            m = mesh(shape)
            _, bundle = steps.make_serve_step(f32(arch, **over), m)
            cfg, rules = steps._with_tp_pad(f32(arch, **over), m), bundle["rules"]
            params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, weights(bundle["specs"], 3)), bundle["param_sh"])
            tree = S.cache_spec_tree(cfg, ShapeConfig("d", DECODE["ctx"], DECODE["batch"], "decode"))
            cache = jax.device_put(jax.tree_util.tree_map(jnp.asarray, weights(tree, 9)), rules.tree_shardings(tree))
            dec = encdec.decode_step if cfg.family == "encdec" else lm.decode_step
            fn = jax.jit(lambda p, c, t, q: dec(cfg, p, c, t, q, rules=rules, backend="xla"))
            tok, pos = (jnp.asarray(DECODE[k], jnp.int32) for k in ("tokens", "pos"))
            logits, cache = fn(params, cache, tok, pos)
            np.savez(out / f"{case}.ref.npz", logits=np.asarray(logits), **flat(jax.tree_util.tree_map(np.asarray, cache), "c/"))
    else:
        for case, shape in (("serve_12", (1, 2)), ("serve_22", (2, 2))):
            cfg = f32(QWEN, tp_pad=shape[1] if shape[1] > 1 else 0)
            np.savez(out / f"{case}.ref.npz", tokens=serve_tokens(QWEN, cfg, mesh(shape)))
        for case, arch, shape, over in TP_TRAIN_CASES:
            train(case, f32(arch, **over), mesh(shape))
        for case, arch, shape in TP_SERVE_CASES:
            np.savez(out / f"{case}.ref.npz", tokens=serve_tokens(arch, f32(arch, tp_pad=shape[1]), mesh(shape)))


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def rank_main(rank: int, world: int, out: pathlib.Path, staged: bool = False) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel import host_staged

    dist.init_process_group(
        host_staged.register() if staged else "gloo",
        init_method=f"file://{out}/store",
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=120),
    )
    try:
        torch.manual_seed(0)

        def mesh(shape):
            # every rank builds every mesh (a collective); ranks outside skip
            n = shape[0] * shape[1]
            m = DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=("data", "model"))
            return m if rank < n else None

        cases = CASES_STAGED if staged else CASES_8 if world == 8 else CASES_4
        for name, fn in cases:
            res = fn(mesh, rank)
            if res is not None and rank == 0:
                np.savez(out / f"{name}.port.npz", **res)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _pcfg(arch, **kw):
    import torch

    from repro_torch.configs import registry

    return dataclasses.replace(registry.get(arch), param_dtype=torch.float32, **kw)


def _tensors(tree):
    import torch

    from repro_torch.models.params import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _moe_case(cf):
    def run(mesh, rank):
        from repro_torch.models import layers as L
        from repro_torch.models.params import default_rules, shard_full, tree_map

        m = mesh((2, 4))
        cfg = _pcfg(MOE) if cf is None else _pcfg(MOE, capacity_factor=cf)
        rules = default_rules(m)
        specs = L.moe_specs(cfg)
        p = tree_map(lambda t, s: shard_full(t, m, rules.placements(s)), _tensors(weights(specs, 1)), specs)
        x = _tensors({"x": moe_x(cfg)})["x"]
        xd = shard_full(x, m, rules.placements_for(x.shape, ("batch", None, "embed")))
        y = L.moe_apply(p, xd, cfg=cfg, rules=rules).full_tensor()
        local = L.moe_apply(_tensors(weights(specs, 1)), x, cfg=cfg)
        return {"y": y.numpy(), "local": local.numpy()}

    return run


def _moe_replicated_case(mesh, rank):
    """deepseek's MoE block (4 experts, 1 shared) on (1, 3), where the
    experts do not divide "model" and the rules replicate them (the shared
    experts shard): its output and every weight's gradient
    against the local path (the expert products' gradients whole, not
    summed over the model ranks)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models.params import default_rules, shard_full, tree_map

    m = mesh((1, 3))
    if m is None:
        return None
    cfg = _pcfg(MOE_SHARED)
    rules = default_rules(m)
    specs = L.moe_specs(cfg)
    w = weights(specs, 1)
    p = tree_map(lambda t, s: shard_full(t, m, rules.placements(s)).requires_grad_(True), _tensors(w), specs)
    x = _tensors({"x": moe_x(cfg)})["x"]
    y = L.moe_apply(p, shard_full(x, m, rules.placements_for(x.shape, ("batch", None, "embed"))), cfg=cfg, rules=rules)
    (y.to_local() * y.to_local()).sum().backward()
    local = tree_map(lambda t: t.requires_grad_(True), _tensors(w))
    y0 = L.moe_apply(local, x, cfg=cfg)
    (y0 * y0).sum().backward()
    res = {"y": y.full_tensor().detach().numpy(), "y0": y0.detach().numpy()}
    res.update(flat(tree_map(lambda t: t.grad.full_tensor().numpy(), p), "g/"))
    res.update(flat(tree_map(lambda t: t.grad.numpy(), local), "g0/"))
    res["experts_placement"] = np.array(str(tuple(p["w_gate"].placements)))
    return res


def _train_case(strategy, compress=False, arch=QWEN, shape=(2, 4), over=None):
    def run(mesh, rank):
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.data.pipeline import DataConfig, TokenSource
        from repro_torch.launch.train import place_batch
        from repro_torch.models import carry
        from repro_torch.models.params import tree_map
        from repro_torch.optim import adamw
        from repro_torch.parallel import steps

        m = mesh(shape)
        if m is None:
            return None
        cfg = _pcfg(arch, **(over or {}))
        sh = ShapeConfig(*TRAIN_SHAPE)
        opt_cfg = adamw.AdamWConfig(grad_compress=compress, **OPT)
        step, bundle, _ = steps.jit_train_step(cfg, m, sh, opt_cfg, strategy=strategy)
        w = weights(bundle["specs"], 0)
        params = carry.shard_params(_tensors(w), bundle)
        opt = adamw.init_state(params, opt_cfg, bundle["opt_sh"]["m"])
        b = TokenSource(bundle["cfg"], sh, DataConfig()).batch_at(0)
        params, opt, metrics = step(params, opt, place_batch(b, bundle["batch_sh"], "cpu"))
        # every leaf, moment and gradient back at its logical placement
        # (the moments at ZeRO-1's, the gradients redistributed there)
        tree_map(lambda t, sh: _same_placements(t, sh), params, bundle["param_sh"])
        tree_map(lambda t, sh: _same_placements(t, sh), opt["m"], bundle["opt_sh"]["m"])
        full = carry.gather_params(params)
        # the same step without a mesh, on the same (padded) config
        step0, _ = steps.make_train_step(bundle["cfg"], opt_cfg)
        p0 = _tensors(w)
        p0, _, m0 = step0(p0, adamw.init_state(p0, opt_cfg), place_batch(b, None, "cpu"))
        res = {"loss": metrics["loss"].numpy(), "grad_norm": metrics["grad_norm"].numpy()}
        res.update(loss0=m0["loss"].numpy(), grad_norm0=m0["grad_norm"].numpy())
        res.update(flat(tree_map(lambda t: t.numpy(), full), "p/"))
        res.update(flat(tree_map(lambda t: t.numpy(), p0), "p0/"))
        res.update(flat(w, "w/"))
        res["zero1_data_shards"] = np.array(
            sum(any(p.is_shard() for p in t.placements[:1]) for t in _leaves_of(opt["m"]))
        )
        return res

    return run


def _same_placements(t, sh) -> None:
    if tuple(t.placements) != tuple(sh.placements):
        raise AssertionError(f"placements {tuple(t.placements)}, expected {tuple(sh.placements)}")


def _leaves_of(tree):
    return [t for _, t in _leaves(tree)]


def _decode_case(arch, shape, over):
    """One f32 decode step over a random cache on ``shape`` (logits and
    every cache leaf after it) and the same step without a mesh."""

    def run(mesh, rank):
        import torch

        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import specs as S
        from repro_torch.models import carry, encdec, lm
        from repro_torch.models.params import shard_full, tree_map
        from repro_torch.parallel import steps

        m = mesh(shape)
        if m is None:
            return None
        _, bundle = steps.make_serve_step(_pcfg(arch, **over), mesh=m)
        cfg, rules = bundle["cfg"], bundle["rules"]
        w = _tensors(weights(bundle["specs"], 3))
        tree = S.cache_spec_tree(cfg, ShapeConfig("d", DECODE["ctx"], DECODE["batch"], "decode"))
        cache_np = weights(tree, 9)
        cache = {k: shard_full(torch.from_numpy(v.copy()), m, rules.placements(tree[k])) for k, v in cache_np.items()}
        tok, pos = (torch.tensor(DECODE[k], dtype=torch.int32) for k in ("tokens", "pos"))
        bpl = rules.placements_for(tuple(tok.shape), ("batch",))
        dec = encdec.decode_step if cfg.family == "encdec" else lm.decode_step
        logits, cache = dec(cfg, carry.shard_params(w, bundle), cache, shard_full(tok, m, bpl), shard_full(pos, m, bpl), rules=rules)
        res = {"logits": logits.full_tensor().numpy()}
        res.update(flat(tree_map(lambda t: t.full_tensor().numpy(), cache), "c/"))
        plain, cache0 = dec(cfg, w, _tensors(cache_np), tok, pos)
        res["logits0"] = plain.numpy()
        res.update(flat(tree_map(lambda t: t.numpy(), cache0), "c0/"))
        return res

    return run


def _serve_case(shape, arch=QWEN):
    def run(mesh, rank):
        from repro_torch.launch.serve import BatchedServer
        from repro_torch.parallel import steps

        m = mesh(shape)
        if m is None:
            return None
        cfg = _pcfg(arch)
        _, bundle = steps.make_serve_step(cfg, mesh=m)
        w = weights(bundle["specs"], 3)
        res = {}
        for what, kw in (("mesh", dict(mesh=m)), ("plain", dict(device="cpu"))):
            server = BatchedServer(bundle["cfg"] if what == "plain" else cfg, params=_tensors(w), **SERVE, **kw)
            for slot, prompt in enumerate(PROMPTS):
                server.prefill_prompt(slot, prompt)
            outs = server.decode(DECODE_TOKENS)
            res[what] = np.array([o + [-1] * (DECODE_TOKENS - len(o)) for o in outs])
            leaf = "h" if "h" in server.cache else "k"
            if what == "mesh":
                res["k"] = server.cache[leaf].full_tensor().numpy()
            else:
                res["k_plain"] = server.cache[leaf].numpy()
        return res

    return run


def _ckpt_case(mesh, rank, arch=QWEN, sub="ckpt"):
    """Train one step of ``arch`` on (2, 2), save; restore onto (1, 2) and
    without a mesh; every rank's restored logical arrays are compared on
    rank 0."""

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch.train import place_batch
    from repro_torch.models import carry
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel import steps

    out_dir = pathlib.Path(CKPT_DIR).with_name(sub)
    cfg = _pcfg(arch)
    sh = ShapeConfig(*TRAIN_SHAPE)
    opt_cfg = adamw.AdamWConfig(**OPT)
    m22, m12 = mesh((2, 2)), mesh((1, 2))
    step, bundle, _ = steps.jit_train_step(cfg, m22, sh, opt_cfg)
    params = carry.shard_params(_tensors(weights(bundle["specs"], 5)), bundle)
    opt = adamw.init_state(params, opt_cfg, bundle["opt_sh"]["m"])
    b = TokenSource(bundle["cfg"], sh, DataConfig()).batch_at(0)
    params, opt, _ = step(params, opt, place_batch(b, bundle["batch_sh"], "cpu"))
    mgr = CheckpointManager(str(out_dir))
    mgr.save(0, {"params": params, "opt": opt})
    saved = carry.gather_params({"params": params, "opt": {k: v for k, v in opt.items()}})
    like = {"params": bundle["specs"], "opt": steps.opt_like(bundle["specs"], opt_cfg)}
    res = {}
    if m12 is not None:
        _, b12, _ = steps.jit_train_step(cfg, m12, sh, opt_cfg)
        got = mgr.restore(0, like, shardings={"params": b12["param_sh"], "opt": b12["opt_sh"]})
        placed = tree_map(lambda t: str(tuple(t.placements)) if hasattr(t, "placements") else "plain", got)
        got = carry.gather_params(got)
        res.update(flat(tree_map(lambda t: t.numpy(), got), "r12/"))
        lp = placed["params"]["layers" if "layers" in placed["params"] else "dec_layers"]
        res["placements_wq"] = np.array(lp["mamba"]["w_in"] if "mamba" in lp else lp["attn"]["wq"])
    plain = mgr.restore(0, like, "cpu")
    res.update(flat(tree_map(lambda t: t.numpy(), plain), "r0/"))
    res.update(flat(tree_map(lambda t: t.numpy(), saved), "saved/"))
    return res if rank == 0 else None


def _comm_case(mesh, rank):
    """Collectives of one dense layer's forward and backward and of one
    decode step on (1, 2), counted with ``CommDebugMode``."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import lm
    from repro_torch.models.params import default_rules, shard_full, tree_map
    from repro_torch.parallel import steps

    m = mesh((1, 2))
    if m is None:
        return None
    cfg = dataclasses.replace(_pcfg(QWEN), n_layers=1, remat="none")
    _, bundle = steps.make_serve_step(cfg, mesh=m)
    rules = bundle["rules"]
    params = tree_map(lambda t, s: shard_full(t, m, rules.placements(s)), _tensors(weights(bundle["specs"], 7)), bundle["specs"])
    lp = lm._layer(params["layers"], 0)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    xd = shard_full(x, m, rules.placements_for(x.shape, lm.SEQ_ACT)).requires_grad_(True)
    pos = torch.arange(16, dtype=torch.int32)[None]
    res = {}
    with CommDebugMode() as comm:
        y = lm._dense_layer_apply(bundle["cfg"], lp, xd, pos, rules)
    res["fwd"] = _counts(comm)
    with CommDebugMode() as comm:
        y.to_local().sum().backward()
    res["bwd"] = _counts(comm)
    cache = {k: shard_full(torch.zeros(1, 2, 24, cfg.n_kv, cfg.d_head), m, rules.placements(s))
             for k, s in lm.cache_specs(bundle["cfg"], 2, 24).items()}
    tok = torch.tensor([3, 4], dtype=torch.int32)
    with CommDebugMode() as comm:
        step, _ = steps.make_serve_step(cfg, mesh=m)
        step(params, cache, tok, torch.tensor([0, 13], dtype=torch.int32))
    res["decode"] = _counts(comm)
    return {k: np.array(sorted(v.items()), dtype=object).astype(str) for k, v in res.items()}


def _counts(comm) -> dict:
    return {str(op).split(".")[-1]: n for op, n in comm.get_comm_counts().items()}


def _drill_case(mesh, rank):
    """``train(mesh=)`` on (2, 2) for 4 steps with a checkpoint every 2 and
    a failure before step 3 (the restart restores onto the mesh's
    shardings), against the same run uninterrupted and ``train`` without a
    mesh."""
    from repro_torch.ft.watchdog import FailureInjector
    from repro_torch.launch.train import train
    from repro_torch.models import carry
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw

    m = mesh((2, 2))
    cfg = _pcfg(QWEN)
    kw = dict(steps=4, batch=4, seq=64, seed=0, log_every=100, opt_cfg=adamw.AdamWConfig(**OPT))
    drill = train(cfg, mesh=m, ckpt_dir=str(pathlib.Path(CKPT_DIR).with_name("drill")), ckpt_every=2,
                  injector=FailureInjector({3: RuntimeError("drill")}), **kw)
    whole = train(cfg, mesh=m, **kw)
    plain = train(cfg, device="cpu", **kw)
    res = {k: np.array(v["losses"]) for k, v in (("drill", drill), ("whole", whole), ("plain", plain))}
    res["restores"] = np.array(sum(r["op"] == "restore" for r in drill["ckpt_log"]))
    for name, out in (("drill", drill), ("whole", whole)):
        res.update(flat(tree_map(lambda t: t.numpy(), carry.gather_params(out["params"])), name + "/"))
    return res


CKPT_DIR = ""
CASES_8 = [
    ("moe_ep", _moe_case(None)),
    ("moe_drop", _moe_case(0.5)),
    ("train_tp", _train_case("tp")),
    ("train_fsdp", _train_case("fsdp")),
    ("train_compress", _train_case("tp", compress=True)),
    *((c, _decode_case(a, sh, o)) for c, a, sh, o in DECODE_CASES),
]
CASES_4 = [
    ("serve_12", _serve_case((1, 2))),
    ("serve_22", _serve_case((2, 2))),
    ("train_mamba", _train_case("tp", arch=MAMBA, shape=(2, 1))),
    ("ckpt", _ckpt_case),
    ("comm", _comm_case),
    ("drill", _drill_case),
    ("train_encdec", _train_case("tp", arch="seamless-m4t-large-v2-smoke", shape=(2, 1))),
    ("train_hybrid", _train_case("fsdp", arch="zamba2-1.2b-smoke", shape=(2, 2))),
    *((c, _train_case("tp", arch=a, shape=sh, over=o)) for c, a, sh, o in TP_TRAIN_CASES),
    *((c, _serve_case(sh, a)) for c, a, sh in TP_SERVE_CASES),
    ("moe_replicated", _moe_replicated_case),
    ("ckpt_mamba", lambda mesh, rank: _ckpt_case(mesh, rank, MAMBA, "ckpt_mamba")),
    ("ckpt_seamless", lambda mesh, rank: _ckpt_case(mesh, rank, SEAMLESS, "ckpt_seamless")),
]
# the same (1, 2) train step with every collective staged through host
# copies (``parallel/host_staged.py``, the path of gloo ranks on a card)
CASES_STAGED = [("staged_train", _train_case("tp", shape=(1, 2)))]


def main(argv=None) -> int:
    global CKPT_DIR
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["ref", "rank"])
    ap.add_argument("--devices", type=int)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--out", required=True)
    ap.add_argument("--staged", action="store_true")
    a = ap.parse_args(argv)
    out = pathlib.Path(a.out)
    CKPT_DIR = str(out / "ckpt")
    try:
        if a.what == "ref":
            ref_main(a.devices, out)
        else:
            rank_main(a.rank, a.world, out, a.staged)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
