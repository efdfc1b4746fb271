"""Port parity: data-parallel (FSDP) training over a mesh against the JAX
package on the CPU.

The port's meshes name the CPU several times (a (4, 1) `data` x `model`
mesh is four shards in one process); the JAX side runs once, in one
subprocess with four forced host devices: `build_train` jitted with
`rules_for_cell`'s shardings on `make_host_mesh(data=4)`, as the JAX
driver runs it, for 3 steps of `TokenPipeline` batches on a reduced
granite-3-2b (dense) and a reduced olmoe-1b-7b (8 experts, top 2, so
slots drop at capacity), one step on a batch whose ignored labels fall
unevenly over the shards, and `compressed_psum` under `shard_map`. Its
initial parameters are carried onto the port's mesh
(`convert.params_from_arrays(shardings=...)`). Tolerances:

- the logical-axis tables, the cell rules, the settings and the
  optimizer-state axes: equal, for every config of `ARCH_IDS` on (4, 1)
  and (2, 2) meshes; every placed parameter and optimizer state holds
  the slice shape the JAX sharding gives it;
- `launch.train.run` over the mesh against the JAX steps: each step's
  loss to rtol 1e-4 (tests/test_torch_training.py's), its grad norm to
  rtol 1e-3 (bf16 gradients summed by two frameworks; 5e-4 measured on
  the MoE config); every leaf's gradient at step 0 within 3e-2 of the
  leaf's largest (tests/test_torch_training.py's; largest gap measured
  0.7% dense, 0.95% MoE) against the JAX gradient of the whole batch,
  whose MoE layers route as the port's did (a router near-tie may send
  a token to another expert in XLA; routed by its own logits, the JAX
  MoE leaves part from the port's by up to 27%); and on the dense config
  99% of each leaf's changes over the run within 5% of its largest
  (0.32% measured outside: a gradient element below the two frameworks'
  bf16 noise may change sign, which turns AdamW's normalized step
  round). The MoE config's later steps route by each framework's own
  logits, so its changes are held by the losses and grad norms;
- the uneven-label batch: loss rtol 1e-4, grad norm rtol 1e-3; a mean of
  the shards' own means misses the JAX loss by more than 1e-4;
- MoE at capacity: the slots the mesh step drops equal one stable sort of
  every slot of the batch at the whole batch's capacity (the JAX
  dispatch under a data mesh), exactly, and differ from each shard's
  own dispatch at its local capacity;
- the mesh step against the port's unsharded step at microbatches =
  shards (2 and 4, dense): losses, grad norms and parameters bit for bit
  (each shard computes what its microbatch does, the gradients add in
  the same order and the norm's float64 partials round to the same
  float32 norm); the MoE config
  differs there by design (the whole batch's capacity);
- one optimizer update of placed leaves (AdamW, Adafactor with its
  cross-shard means) from identical numpy gradients and states against
  the JAX optimizer: tests/test_torch_training.py's optimizer-step
  tolerance (rtol 1e-6 and one float32 ulp of the leaf's largest value);
- `compressed_psum`: the residuals bit for bit, the outputs within two
  float32 ulps of their largest (sums in another order);
- checkpoints: restored onto 2 shards and onto no mesh bit for bit, and
  the resumed runs' losses to rtol 1e-5 of the uninterrupted run's.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.launch import cells as jcells
from repro.launch.steps import opt_state_axes as jopt_state_axes
from repro.nn import moe as jmoe
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import param_axes as jparam_axes
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import opt_state_from_arrays, params_from_arrays
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.distributed import compression
from repro_torch.distributed.fault import elastic_shardings
from repro_torch.distributed.sharding import Mesh, named_sharding
from repro_torch.launch.cells import (optimizer_for, rules_for_cell,
                                      settings_for)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import build_train, opt_state_axes
from repro_torch.launch.train import run
from repro_torch.models import loss_fn
from repro_torch.models.lm import LM, layer_axes, param_axes
from repro_torch.nn import moe
from _torch_threads import torch_threads_per_worker  # noqa: F401

CPU = torch.device("cpu")
SEQ, BATCH, STEPS, LR, SEED = 32, 8, 3, 3e-3, 0
CASES = {
    "dense": ("granite_3_2b", dict(n_groups=2, d_model=64, n_heads=4,
                                   n_kv_heads=2, d_ff=128), {}),
    # 8 experts, top 2: capacity drops slots
    "moe": ("olmoe_1b_7b", dict(n_groups=2, d_model=64, n_heads=4,
                                n_kv_heads=4, d_ff=128, n_experts=8),
            {"top_k": 2}),
}
SHAPE = ShapeSpec("custom", SEQ, BATCH, "train")


def _cfg(name):
    arch, kw, extra = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(**kw), **extra)


def _mesh(data, model=1):
    return Mesh(np.array([[CPU] * model] * data, dtype=object),
                ("data", "model"))


def _uneven_batch():
    """Labels ignored mostly on the first shard's rows, none on the last
    shard's."""
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)
    lab = rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)
    lab[:2, 3:] = -1
    lab[2, 10:] = -1
    return tok, lab


_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    assert len(jax.devices()) == 4, jax.devices()
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.data import DataConfig, TokenPipeline
    from repro.distributed.compression import EFState, compressed_psum
    from repro.distributed.sharding import compat_shard_map, use_rules
    from repro.launch.cells import rules_for_cell, settings_for
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_train
    from repro.models import init_params

    CASES = %r
    SEQ, BATCH, STEPS, LR, SEED = %r
    inp = np.load(sys.argv[1])


    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}" if prefix else k))
            return out
        return {prefix: tree}


    out = {}
    mesh = make_host_mesh(data=4)
    for name, (arch, kw, extra) in CASES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(**kw), **extra)
        shape = ShapeSpec("custom", SEQ, BATCH, "train")
        st = dataclasses.replace(settings_for(arch, shape), microbatches=1)
        rules = rules_for_cell(mesh, cfg, shape, st)
        step, _, shardings, tx = build_train(cfg, st, shape, lr=LR,
                                             total_steps=STEPS)
        in_sh, out_sh = shardings(mesh, rules)
        params = init_params(jax.random.PRNGKey(SEED), cfg)
        opt = tx.init(params)
        for tag, tree, sh in (("params", params, in_sh[0]),
                              ("opt", opt, in_sh[1])):
            leaves = flat(tree)
            for path, s in flat(sh).items():
                out[f"{name}/shard/{tag}/{path}"] = np.asarray(
                    s.shard_shape(leaves[path].shape))
        for path, a in flat(params).items():
            out[f"{name}/p0/{path}"] = np.asarray(a)
        p0 = params = jax.device_put(params, in_sh[0])
        o0 = opt = jax.device_put(opt, in_sh[1])
        jstep = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=SEQ, global_batch=BATCH,
                                        seed=SEED))
        with use_rules(mesh, rules):
            for i in range(STEPS):
                batch = {k: jnp.asarray(v) for k, v in next(pipe).items()}
                params, opt, m = jstep(params, opt, batch)
                out[f"{name}/loss{i}"] = np.asarray(m["loss"])
                out[f"{name}/gnorm{i}"] = np.asarray(m["grad_norm"])
            if name == "dense":
                _, _, m = jstep(p0, o0, {k: jnp.asarray(inp[k])
                                         for k in ("tokens", "labels")})
                out["uneven/loss"] = np.asarray(m["loss"])
                out["uneven/gnorm"] = np.asarray(m["grad_norm"])
        for path, a in flat(params).items():
            out[f"{name}/p{STEPS}/{path}"] = np.asarray(a)

    # compressed_psum over `data`, two rounds, the second on the first's
    # residuals
    mesh1 = Mesh(np.array(jax.devices()), ("data",))


    def body(x, r):
        o, ef = compressed_psum(x, EFState(r), "data")
        return o, ef.residual


    f = jax.jit(compat_shard_map(body, mesh=mesh1,
                                 in_specs=(P("data"), P("data")),
                                 out_specs=(P("data"), P("data"))))
    r = jnp.zeros_like(inp["psum0"])
    for i in range(2):
        o, r = f(jnp.asarray(inp[f"psum{i}"]), r)
        out[f"psum/out{i}"] = np.asarray(o)
        out[f"psum/res{i}"] = np.asarray(r)
    np.savez(sys.argv[2], **out)
    print("JAX-FSDP-OK")
""") % (CASES, (SEQ, BATCH, STEPS, LR, SEED))


def _psum_inputs():
    rng = np.random.default_rng(7)
    return [rng.normal(size=(12, 33)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_fsdp(tmp_path_factory):
    """The JAX side, from one subprocess with four host devices."""
    d = tmp_path_factory.mktemp("fsdp")
    tok, lab = _uneven_batch()
    x0, x1 = _psum_inputs()
    np.savez(d / "in.npz", tokens=tok, labels=lab, psum0=x0, psum1=x1)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                           str(d / "in.npz"), str(d / "out.npz")],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0 and "JAX-FSDP-OK" in proc.stdout, \
        proc.stderr
    return dict(np.load(d / "out.npz"))


def _tree(out, prefix):
    """The arrays under `prefix` as the JAX pytree (nested dicts)."""
    tree = {}
    for key, arr in out.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def _node(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def _stacked(path, tensors):
    arrs = [t.numpy() if isinstance(t, torch.Tensor) else t
            for t in tensors]
    return np.stack(arrs) if path.startswith("groups/") else arrs[0]


def _placed_model(out, name, mesh, rules):
    """The JAX initial parameters carried onto `mesh`."""
    cfg = _cfg(name)
    _, tx, shardings = build_train(cfg, mesh=mesh, rules=rules, lr=LR,
                                   total_steps=STEPS)
    (p_sh, o_sh, _), _ = shardings(mesh, rules)
    return params_from_arrays(_tree(out, f"{name}/p0/"), cfg,
                              shardings=p_sh), tx, (p_sh, o_sh)


def _rules(name, mesh):
    arch = CASES[name][0]
    return rules_for_cell(mesh, _cfg(name), SHAPE, settings_for(arch, SHAPE))


def _run(cfg, **kw):
    with tempfile.TemporaryDirectory() as d:
        return run(cfg, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, seed=SEED,
                   ckpt_dir=d, save_every=100, log=lambda m: None, **kw)


# ---------------------------------------------------------------------------
# (i) the tables
# ---------------------------------------------------------------------------


def _jflat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jflat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_rules_and_settings_match_jax(arch, shape):
    """param_axes, settings_for at every shape kind (the fields the port
    keeps), optimizer_for, rules_for_cell at every shape (the serving
    ones too), the specs `named_sharding` gives each leaf
    and the optimizer-state axes, against the JAX functions (the JAX
    side reads only a mesh's axis names and `model` size, so a stand-in
    mesh serves)."""
    assert list(ARCH_IDS) == list(JARCH_IDS)
    cfg, jcfg = get_config(arch), jget_config(arch)
    axes = param_axes(cfg)
    assert axes == {k: tuple(v) for k, v in _jflat(jparam_axes(jcfg)).items()}
    assert list(axes) == list(LM(cfg, device="meta").leaves())
    mesh = _mesh(*shape)
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": shape[0],
                                         "model": shape[1]})
    trained = 0
    for sname, s in SHAPES.items():
        st, jst = settings_for(arch, s), jcells.settings_for(arch, JSHAPES[
            sname])
        assert dataclasses.asdict(st) == {
            f.name: getattr(jst, f.name) for f in dataclasses.fields(st)}
        assert optimizer_for(cfg) == st.optimizer
        trained += s.kind == "train"
        rules = rules_for_cell(mesh, cfg, s, st)
        jrules = jcells.rules_for_cell(jmesh, jcfg, JSHAPES[sname], jst)
        assert rules == jrules
        with jsharding.use_rules(jmesh, jrules):
            for path, ax in axes.items():
                assert named_sharding(mesh, rules, ax).spec == tuple(
                    jsharding.resolve_spec(ax)), path
    assert trained
    # the optimizer state's axes, from the shapes of the reduced config
    red, jred = cfg.reduced(), jcfg.reduced()
    shapes = {p: a.shape for p, a in _jflat(jax.eval_shape(
        lambda: jinit_params(jax.random.PRNGKey(0), jred))).items()}
    for opt_name in ("adamw", "adafactor"):
        want = jopt_state_axes(opt_name, jparam_axes(jred), jax.eval_shape(
            lambda: jinit_params(jax.random.PRNGKey(0), jred)))
        got = opt_state_axes(opt_name, param_axes(red), shapes)
        if opt_name == "adamw":
            want_flat = {f"{k}/{p}": tuple(v) for k in ("m", "v")
                         for p, v in _jflat(want[k]).items()}
            got_flat = {f"{k}/{p}": v for k in ("m", "v")
                        for p, v in got[k].items()}
        else:
            want_flat = {p: tuple(v) for p, v in _jflat(want["f"]).items()}
            got_flat = {f"{p}/{k}": v for p, st in got["f"].items()
                        for k, v in st.items()}
        assert got_flat == want_flat and got["step"] == tuple(want["step"])


# ---------------------------------------------------------------------------
# (ii) the mesh trainer against the JAX trainer
# ---------------------------------------------------------------------------


def _first_update(monkeypatch, routes: list) -> dict:
    """Make `nn.moe.topk_route` append each call's top-k indices to
    `routes`, and `build_train`'s optimizer keep, at its first update,
    the gradients read whole ("grads": {leaf path: numpy array}, stacked
    as the JAX pytree) and the number of routing calls made until then
    ("routes"), in the returned dict."""
    seen: dict = {}
    route, real = moe.topk_route, steps_mod.make_optimizer

    def recording(logits, k):
        topi, w = route(logits, k)
        routes.append(topi.clone())
        return topi, w

    def make(name, lr, **kw):
        tx = real(name, lr, **kw)

        def update(grads, state, params):
            if not seen:
                seen["grads"] = {k: _stacked(k, [g.numpy() for g in gs])
                                 for k, gs in grads.items()}
                seen["routes"] = len(routes)
            return tx.update(grads, state, params)
        return optim.Transform(tx.init, update)
    monkeypatch.setattr(moe, "topk_route", recording)
    monkeypatch.setattr(steps_mod, "make_optimizer", make)
    return seen


def _batch_routes(routes: list, shards: int, layers: int) -> list:
    """A mesh step's routing calls (each shard's forward, layer by layer,
    then its remat recomputation) -> each MoE layer's top-k indices of
    the whole batch, the shards' rows in order."""
    per = len(routes) // shards
    assert per * shards == len(routes) and per in (layers, 2 * layers)
    chunks = [routes[k * per:(k + 1) * per] for k in range(shards)]
    for c in chunks:                  # the recomputation routes alike
        assert all(any(torch.equal(a, b) for a in c[:layers])
                   for b in c[layers:])
    return [torch.cat([c[layer] for c in chunks]) for layer in range(layers)]


def _jax_first_grads(out, name, batch, topis, monkeypatch) -> dict:
    """The JAX package's gradient of its loss at the initial parameters
    on `batch` (the whole batch: its MoE capacity is the batch's, as the
    JAX step's under a data mesh), {leaf path: array}. Each MoE layer
    routes by `topis` (the port's routing), so that a router near-tie
    cannot send a token to another expert in XLA
    (tests/test_torch_archs.py's `_fixed_route`); the groups run as a
    Python loop, so each layer traces its own routing call."""
    arch, kw, extra = CASES[name]
    jcfg = dataclasses.replace(jget_config(arch).reduced(**kw), **extra,
                               remat=False, unroll_groups=True)
    calls = iter(topis)

    def fixed(params, x2d, cfg):
        logits = (x2d @ params["router"].astype(jmoe.CDT)).astype(
            jnp.float32)
        topi = jnp.asarray(next(calls).numpy().astype(np.int32))
        w = jax.nn.softmax(jnp.take_along_axis(logits, topi, axis=-1),
                           axis=-1)
        return topi, w.astype(jmoe.CDT)
    monkeypatch.setattr(jmoe, "_route", fixed)
    grad = jax.jit(jax.grad(lambda p, b: jloss_fn(p, jcfg, b)))
    params = jax.tree.map(jnp.asarray, _tree(out, f"{name}/p0/"))
    grads = grad(params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert next(calls, None) is None          # one call a MoE layer
    return {path: np.asarray(g, dtype=np.float32)
            for path, g in _jflat(grads).items()}


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_run_matches_jax(jax_fsdp, name, monkeypatch):
    """`run` over a CPU mesh of 4 from the JAX initial parameters: the
    JAX losses and grad norms step by step, every leaf's gradient at
    step 0, every leaf's change over the run, and every placed
    parameter and optimizer state held as its slices of the JAX
    sharding's shape."""
    out = jax_fsdp
    cfg, mesh = _cfg(name), _mesh(4)
    rules = _rules(name, mesh)
    model, tx, _ = _placed_model(out, name, mesh, rules)
    for tag, tree in (("params", model.leaves()),
                      ("opt", tx.init(model.leaves()))):
        flat = {f"{k}/{p}": v for k in ("m", "v") for p, v in
                tree[k].items()} if tag == "opt" else tree
        for path, ps in flat.items():
            want = tuple(out[f"{name}/shard/{tag}/{path}"])
            lead = (len(ps),) if "groups/" in path else ()
            for p in ps:
                assert all(lead + tuple(t.shape) == want
                           for t in p.distinct()), (path, want)
        if tag == "opt":
            assert tuple(out[f"{name}/shard/opt/step"]) == ()
    routes: list = []
    first = _first_update(monkeypatch, routes)
    hist = _run(cfg, params=model, mesh=mesh, rules=rules)
    for i, h in enumerate(hist):
        assert h["loss"] == pytest.approx(float(out[f"{name}/loss{i}"]),
                                          rel=1e-4)
        assert h["grad_norm"] == pytest.approx(
            float(out[f"{name}/gnorm{i}"]), rel=1e-3)
    assert len(hist[0]["launches_by_shard"]) == 4
    layers = cfg.n_groups * sum(spec.moe for spec in cfg.group_spec)
    if name == "moe":
        assert all(h["moe_dropped"] > 0 for h in hist) and layers
    batch = next(TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH,
                                          seed=SEED)))
    want = _jax_first_grads(out, name, batch, _batch_routes(
        routes[:first["routes"]], 4, layers) if layers else [], monkeypatch)
    assert set(first["grads"]) == set(want) == set(model.leaves())
    for path, got in first["grads"].items():
        scale = max(float(np.abs(want[path]).max()), 1e-30)
        np.testing.assert_allclose(got / scale, want[path] / scale, rtol=0,
                                   atol=3e-2, err_msg=path)
    if name == "moe":
        return          # later steps' routing may part at a near-tie
    p0, p3 = _tree(out, f"{name}/p0/"), _tree(out, f"{name}/p{STEPS}/")
    for path, ps in model.leaves().items():
        start = _node(p0, path)
        got = _stacked(path, [p.numpy() for p in ps]) - start
        change = _node(p3, path) - start
        off = np.abs(got - change) > 0.05 * np.abs(change).max()
        assert off.mean() <= 0.01, (path, off.mean())


# ---------------------------------------------------------------------------
# (iii) ignored labels spread unevenly; (iv) MoE capacity of the batch
# ---------------------------------------------------------------------------


def test_uneven_labels_take_the_batch_count(jax_fsdp):
    """The loss is the whole batch's masked mean: each shard's nll sum
    over the batch's label count, however the ignored labels fall."""
    out = jax_fsdp
    cfg, mesh = _cfg("dense"), _mesh(4)
    rules = _rules("dense", mesh)
    model, tx, _ = _placed_model(out, "dense", mesh, rules)
    step, _, _ = build_train(cfg, mesh=mesh, rules=rules, lr=LR,
                             total_steps=STEPS)
    tok, lab = _uneven_batch()
    whole = model.gather(CPU)
    _, metrics = step(model, tx.init(model.leaves()),
                      {"tokens": tok, "labels": lab})
    want = float(out["uneven/loss"])
    assert float(metrics["loss"]) == pytest.approx(want, rel=1e-4)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(out["uneven/gnorm"]), rel=1e-3)
    counts = (lab >= 0).reshape(4, -1).sum(-1)
    assert len(set(counts.tolist())) > 1
    with torch.no_grad():
        means = [float(loss_fn(whole, cfg, {
            "tokens": torch.tensor(tok[2 * k:2 * k + 2]),
            "labels": torch.tensor(lab[2 * k:2 * k + 2])}))
            for k in range(4)]
    assert abs(np.mean(means) - want) > 1e-4 * abs(want)


def test_moe_drops_are_the_batch_dispatchs(jax_fsdp, monkeypatch):
    """One mesh step of the olmoe config (remat off, so each layer routes
    once a shard): its dropped slots are exactly those of one stable sort
    of every slot of the batch at the batch's capacity, layer by layer,
    and a dispatch of each shard at its own capacity drops others; the
    loss is the JAX step's."""
    out = jax_fsdp
    cfg = dataclasses.replace(_cfg("moe"), remat=False)
    mesh = _mesh(4)
    rules = _rules("moe", mesh)
    model, tx, _ = _placed_model(out, "moe", mesh, rules)
    step, _, _ = build_train(cfg, mesh=mesh, rules=rules, lr=LR,
                             total_steps=STEPS)
    routed = []
    route = moe.topk_route

    def recording(logits, k):
        topi, w = route(logits, k)
        routed.append(topi)
        return topi, w
    monkeypatch.setattr(moe, "topk_route", recording)
    batch = next(TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH,
                                          seed=SEED)))
    _, metrics = step(model, tx.init(model.leaves()), batch)
    assert float(metrics["loss"]) == pytest.approx(
        float(out["moe/loss0"]), rel=1e-4)
    layers, E, T = cfg.n_groups, cfg.n_experts, BATCH * SEQ
    assert len(routed) == 4 * layers       # shard by shard, layer by layer
    whole = local = 0
    for layer in range(layers):
        parts = routed[layer::layers]
        whole += int((~moe.dispatch(torch.cat(parts), E,
                                    moe.capacity(T, cfg)).keep).sum())
        local += sum(int((~moe.dispatch(t, E, moe.capacity(
            T // 4, cfg)).keep).sum()) for t in parts)
    assert int(metrics["moe_dropped"]) == whole > 0
    assert local != whole


# ---------------------------------------------------------------------------
# (v) the mesh step against the unsharded step at microbatches = shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,shards", [("dense", 2), ("dense", 4),
                                         ("moe", 4)])
def test_mesh_equals_unsharded_microbatches(jax_fsdp, name, shards):
    out = jax_fsdp
    cfg, mesh = _cfg(name), _mesh(shards)
    model, _, _ = _placed_model(out, name, mesh, _rules(name, mesh))
    ref_model = params_from_arrays(_tree(out, f"{name}/p0/"), cfg,
                                   device="cpu")
    ref = _run(cfg, params=ref_model, device="cpu", microbatches=shards)
    hist = _run(cfg, params=model, mesh=mesh)
    if name == "moe":          # the whole batch's capacity, by design
        assert [h["loss"] for h in hist] != [h["loss"] for h in ref]
        return
    for a, b in zip(ref, hist, strict=True):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    for path, ps in model.leaves().items():
        want = _stacked(path, [p.detach() for p in ref_model.leaves()[path]])
        np.testing.assert_array_equal(_stacked(path, [p.numpy() for p in ps]),
                                      want, err_msg=path)


# ---------------------------------------------------------------------------
# the optimizers over placed leaves
# ---------------------------------------------------------------------------


# the JAX optimizers' updates under a warmup-cosine schedule, compiled once
_JSCHED = joptim.warmup_cosine(LR, 200, 100)
_JUPDATE = {"adamw": jax.jit(joptim.adamw(_JSCHED).update),
            "adafactor": jax.jit(joptim.adafactor(_JSCHED).update)}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_placed_optimizer_step_matches_jax(jax_fsdp, kind):
    """One update of the dense config's placed leaves from identical numpy
    gradients and a nonzero state against the JAX optimizer's update of
    the unplaced arrays (Adafactor's vr/vc means and update RMS sum the
    slices across shards); Adafactor's placed state by the JAX axes."""
    out = jax_fsdp
    cfg, mesh = _cfg("dense"), _mesh(4)
    rules = _rules("dense", mesh)
    p0 = _tree(out, "dense/p0/")
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32) * 0.3, p0)
    pos = lambda shape: (1 + rng.random(shape)).astype(np.float32) * 1e-3
    if kind == "adamw":
        state = {"m": jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
                     np.float32) * 0.01, p0),
                 "v": jax.tree.map(lambda p: pos(p.shape), p0),
                 "step": np.int32(3)}
    else:
        state = {"f": jax.tree.map(lambda p: {"vr": pos(p.shape[:-1]),
                                              "vc": pos(p.shape[:-2]
                                                        + p.shape[-1:])}
                                   if p.ndim >= 2 else {"v": pos(p.shape)},
                                   p0), "step": np.int32(3)}
    want_p, want_s, want_gn = _JUPDATE[kind](grads, state, p0)
    tx = optim.adamw(optim.warmup_cosine(LR, 200, 100)) if kind == "adamw" \
        else optim.adafactor(optim.warmup_cosine(LR, 200, 100))
    p_sh = build_train(cfg, mesh=mesh, rules=rules)[2](mesh, rules)[0][0]
    o_axes = opt_state_axes(kind, param_axes(cfg), {
        p: _node(p0, p).shape for p in param_axes(cfg)})
    o_sh = {"m": p_sh, "v": p_sh} if kind == "adamw" else {"f": {
        p: {k: named_sharding(mesh, rules, ax) for k, ax in st.items()}
        for p, st in o_axes["f"].items()}}
    model = params_from_arrays(p0, cfg, shardings=p_sh)
    tstate = opt_state_from_arrays(state, model, shardings=o_sh)
    if kind == "adafactor":     # the placed init lays the state out alike
        fresh = tx.init(model.leaves())["f"]
        for path, st in tstate["f"].items():
            for k, placed in st.items():
                assert fresh[path][k].sharding.spec == placed.sharding.spec
    tgrads = opt_state_from_arrays({"m": grads, "step": 0}, model,
                                   shardings={"m": p_sh})["m"]
    _, tstate, gn = tx.update(tgrads, tstate, model.leaves())
    assert float(gn) == pytest.approx(float(want_gn), rel=1e-6)
    for path, ps in model.leaves().items():
        want = _node(want_p, path)
        np.testing.assert_allclose(_stacked(path, [p.numpy() for p in ps]),
                                   want, rtol=1e-6, atol=np.spacing(
                                       np.abs(want).max()), err_msg=path)
        if kind == "adafactor":
            node = want_s["f"]
            for key in path.split("/"):
                node = node[key]
            for k, placed in tstate["f"][path].items():
                w = np.asarray(node[k])
                np.testing.assert_allclose(placed.numpy(), w, rtol=1e-6,
                                           atol=np.spacing(np.abs(w).max()),
                                           err_msg=f"{path}/{k}")


# ---------------------------------------------------------------------------
# (vi) the compressed all-reduce
# ---------------------------------------------------------------------------


def test_compressed_psum_matches_jax(jax_fsdp):
    out = jax_fsdp
    mesh = Mesh([CPU] * 4, ("data",))
    efs = [compression.init_ef(torch.zeros(3, 33)) for _ in range(4)]
    for i, x in enumerate(_psum_inputs()):
        xs = [torch.from_numpy(x[3 * k:3 * k + 3]) for k in range(4)]
        outs, efs = compression.compressed_psum(xs, efs, mesh)
        want = out[f"psum/out{i}"]
        np.testing.assert_array_equal(
            np.concatenate([e.residual.numpy() for e in efs]),
            out[f"psum/res{i}"])
        np.testing.assert_allclose(np.concatenate([o.numpy() for o in outs]),
                                   want, rtol=0, atol=2 * np.spacing(
                                       np.abs(want).max()))


# ---------------------------------------------------------------------------
# (vii) elastic restores
# ---------------------------------------------------------------------------


def test_elastic_restore_and_resume(jax_fsdp, tmp_path):
    """A 4-shard run saves at step 1; the checkpoint comes back bit for bit
    placed onto 2 shards (`elastic_shardings` of the logical axes) and
    onto no mesh, and runs resumed from it on 2 shards and unsharded give
    the uninterrupted 4-shard run's losses."""
    out = jax_fsdp
    cfg = _cfg("dense")
    mesh4, mesh2 = _mesh(4), _mesh(2)
    tree0 = _tree(out, "dense/p0/")
    kw = dict(batch=BATCH, seq=SEQ, lr=LR, seed=SEED, log=lambda m: None)
    d = str(tmp_path / "ck")
    model = params_from_arrays(tree0, cfg, shardings=build_train(
        cfg, mesh=mesh4, rules=_rules("dense", mesh4))[2](
            mesh4, _rules("dense", mesh4))[0][0])
    run(cfg, steps=2, params=model, mesh=mesh4, ckpt_dir=d, save_every=1,
        **kw)
    full = run(cfg, steps=STEPS, params=params_from_arrays(
        tree0, cfg, device="cpu"), mesh=mesh4, ckpt_dir=str(tmp_path / "x"),
        save_every=100, **kw)
    rules2 = _rules("dense", mesh2)
    n = {"groups": cfg.n_groups}
    axes = {p: [layer_axes(p, ax)] * n.get(p.split("/")[0], 1)
            for p, ax in param_axes(cfg).items()}
    sh = elastic_shardings(mesh2, rules2, {"params": axes, "opt": {
        "m": axes, "v": axes, "step": None}})
    template = {"params": model.leaves(), "opt": {
        "m": model.leaves(), "v": model.leaves(), "step": 0}}
    placed, _ = ckpt.restore_checkpoint(d, template, shardings=sh)
    whole, _ = ckpt.restore_checkpoint(d, {"params": model.gather(
        CPU).leaves()})
    for path, ps in model.leaves().items():
        for p, q, w, s in zip(ps, placed["params"][path],
                              whole["params"][path], sh["params"][path],
                              strict=True):
            assert q.sharding is s and s.mesh is mesh2
            assert all(tuple(t.shape) == s.shard_shape(p.shape)
                       for t in q.distinct())
            assert np.array_equal(q.numpy(), p.numpy())
            assert np.array_equal(w.numpy(), p.numpy())
    for mesh in (mesh2, None):
        resumed_dir = str(tmp_path / f"r{mesh is None}")
        shutil.copytree(d, resumed_dir)
        res = run(cfg, steps=STEPS, mesh=mesh, device="cpu",
                  ckpt_dir=resumed_dir, save_every=100,
                  params=params_from_arrays(tree0, cfg, device="cpu"), **kw)
        assert [h["step"] for h in res] == [1, 2]
        assert res[0]["loss"] == pytest.approx(full[2]["loss"], rel=1e-5)
