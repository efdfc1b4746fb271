"""Port parity: tensor-parallel training over a (data, model) mesh against
the JAX package on the CPU.

The port's meshes name the CPU several times ((2, 2) and (1, 4) `data`
x `model` meshes of one process); the JAX side runs once, in one
subprocess with four forced host devices: `build_train` jitted with
`rules_for_cell`'s shardings on `compat_make_mesh((2, 2))` and
`((1, 4))`, as the JAX driver runs it, for two steps of
`TokenPipeline` batches (four rows of 32 tokens; aux embeddings from
numpy where the config takes them). Its initial parameters are carried
onto the port's mesh (`convert.params_from_arrays(shardings=...)`).
The cases:

- "dense": reduced granite-3-2b (4 heads, 2 KV heads: the KV
  projections replicated on a `model` axis of 4, each position reading
  the KV head its query head uses), naive attention, on (2, 2) (through
  `launch.train.run`) and (1, 4); "flash" the same under
  `attn_impl="flash"` on (1, 4);
- "heads6": 6 heads on (1, 4), which `model` does not divide: `wq`'s
  column slices end mid-head, q is all-gathered and every position
  attends over all heads; its vocabulary (514) does not divide either,
  so the embedding and the tied head stay replicated;
- "moe": reduced olmoe-1b-7b (8 experts, top 2, so slots drop) on
  (2, 2) and (1, 4): four and two experts a position;
- "mamba": reduced falcon-mamba-7b on (2, 2): `d_inner` over `model`,
  `in_proj`'s first position holding all of u and the second all of z;
- "encdec": reduced whisper-small (encoder, decoder self and cross
  attention) on (1, 4).

Tolerances:

- `resolve_spec` and `named_sharding` give the JAX specs under
  `rules_for_cell`'s rules for every leaf of every config on (2, 2) and
  (1, 4); `constrain` is the identity without rules and on a tensor;
  the collectives' values and their adjoint backwards exactly;
- each step's loss within 1e-4 relative of the JAX step's and its grad
  norm within 2e-3: about four times the JAX package's own spread
  across meshes (4e-6 and 5e-4 relative at step 2 of the dense case
  on (1, 1), (4, 1), (2, 2) and (1, 4)), as row-parallel partial sums
  add in another order in either framework. Largest gaps measured:
  loss 3.6e-5 (encdec), grad norm 9.9e-4 (moe); the dense cases 2.5e-5
  and 4.1e-4;
- every leaf's change over the two steps within 5% of the leaf's
  largest change, but for 2% of its elements or 4, whichever is more
  (tests/test_torch_fsdp.py's rule at 1% over three steps): an element
  below the frameworks' bf16 gradient noise may flip AdamW's normalized
  step, and the port's own unsharded trainer already misses the JAX
  changes so in 0.87% of the whisper encoder's `wk` and 2 of the 128
  elements of a norm scale; the tensor-parallel runs measured up to
  1.03% (84 of 8,192, encoder `wk`) and 3 of 128 (decoder `norm2`).
  The MoE case's later step routes by each framework's own logits, so
  it is held leaf by leaf at step 0 instead: every leaf's gradient at
  the first update within 3e-2 of its largest of the JAX gradient of
  the whole batch routed as the port routed (tests/test_torch_fsdp.py's
  check); largest measured 1.42e-2 (the router, (2, 2)), the rest
  under 1e-2;
- the port's unsharded trainer at microbatches = data shards from the
  same weights, non-MoE cases (the MoE capacity is the whole batch's on
  a mesh, by design): the same loss and grad-norm bounds (measured up
  to 3.0e-5 and 4.1e-4), and every parameter within 2e-4 absolute after
  two steps (largest measured 8.6e-5, flash);
- each model position holds 1/M of every leaf the rules split over
  `model` (bytes counted on the placed slices), and every position's
  flash calls carry Hq/M query heads (all Hq where heads do not
  divide);
- a protected checkpoint of a (2, 2) run, with storage faults injected,
  restored onto (2, 2), (4, 1) and no mesh: every leaf bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.launch import cells as jcells
from repro.models import param_axes as jparam_axes
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_arrays
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.distributed import sharding
from repro_torch.distributed.fault import elastic_shardings
from repro_torch.distributed.sharding import (Mesh, Parts, constrain,
                                              model_dim, named_sharding,
                                              resolve_spec)
from repro_torch.launch.cells import rules_for_cell, settings_for
from repro_torch.launch.steps import build_train
from repro_torch.launch.train import run
from repro_torch.memory import uniform_flip
from repro_torch.models.lm import layer_axes, param_axes
from _torch_threads import torch_threads_per_worker  # noqa: F401
import test_torch_fsdp as fsdp_tests

CPU = torch.device("cpu")
SEQ, BATCH, STEPS, LR, SEED = 32, 4, 2, 3e-3, 0
_DENSE = dict(n_groups=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
# name: (arch, reduced kw, replaced fields, meshes)
CASES = {
    "dense": ("granite_3_2b", _DENSE, {}, [(2, 2), (1, 4)]),
    "flash": ("granite_3_2b", _DENSE, {"attn_impl": "flash"}, [(1, 4)]),
    "heads6": ("granite_3_2b", dict(n_groups=2, d_model=96, n_heads=6,
                                    n_kv_heads=2, d_ff=128, vocab=514), {},
               [(1, 4)]),
    "moe": ("olmoe_1b_7b", dict(n_groups=2, d_model=64, n_heads=4,
                                n_kv_heads=4, d_ff=128, n_experts=8),
            {"top_k": 2}, [(2, 2), (1, 4)]),
    "mamba": ("falcon_mamba_7b", dict(n_groups=2, d_model=64, n_heads=4,
                                      d_ff=0), {}, [(2, 2)]),
    "encdec": ("whisper_small", dict(n_groups=2, d_model=64, n_heads=4,
                                     d_ff=128), {"attn_impl": "flash"},
               [(1, 4)]),
}
RUNS = [(name, shape) for name, case in CASES.items() for shape in case[3]]
SHAPE = ShapeSpec("custom", SEQ, BATCH, "train")


def _cfg(name):
    arch, kw, extra, _ = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(**kw), **extra)


def _mesh(data, model):
    return Mesh(np.array([[CPU] * model] * data, dtype=object),
                ("data", "model"))


def _rules(name, mesh):
    return rules_for_cell(mesh, _cfg(name), SHAPE,
                          settings_for(CASES[name][0], SHAPE))


def _batches(name):
    """STEPS TokenPipeline batches, with numpy aux where the config takes
    it."""
    cfg = _cfg(name)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH, seed=SEED))
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        b = dict(next(pipe))
        if cfg.aux_kind:
            b["aux"] = (0.1 * rng.normal(size=(
                BATCH, cfg.n_aux_tokens, cfg.d_model))).astype(np.float32)
        out.append(b)
    return out


_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np
    assert len(jax.devices()) == 4, jax.devices()
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.sharding import use_rules
    from repro.launch.cells import rules_for_cell, settings_for
    from repro.launch.mesh import compat_make_mesh
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
    for name, (arch, kw, extra, meshes) in CASES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(**kw), **extra)
        shape = ShapeSpec("custom", SEQ, BATCH, "train")
        st = dataclasses.replace(settings_for(arch, shape), microbatches=1)
        p0 = init_params(jax.random.PRNGKey(SEED), cfg)
        for path, a in flat(p0).items():
            out[f"{name}/p0/{path}"] = np.asarray(a)
        for ms in meshes:
            tag = f"{name}/{ms[0]}x{ms[1]}"
            mesh = compat_make_mesh(ms, ("data", "model"))
            rules = rules_for_cell(mesh, cfg, shape, st)
            step, _, shardings, tx = build_train(cfg, st, shape, lr=LR,
                                                 total_steps=STEPS)
            in_sh, out_sh = shardings(mesh, rules)
            params = jax.device_put(p0, in_sh[0])
            opt = jax.device_put(tx.init(p0), in_sh[1])
            jstep = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
            with use_rules(mesh, rules):
                for i in range(STEPS):
                    batch = {k[len(f"{name}/b{i}/"):]: jnp.asarray(v)
                             for k, v in inp.items()
                             if k.startswith(f"{name}/b{i}/")}
                    params, opt, m = jstep(params, opt, batch)
                    out[f"{tag}/loss{i}"] = np.asarray(m["loss"])
                    out[f"{tag}/gnorm{i}"] = np.asarray(m["grad_norm"])
            for path, a in flat(params).items():
                out[f"{tag}/p{STEPS}/{path}"] = np.asarray(a)
    np.savez(sys.argv[2], **out)
    print("JAX-TP-OK")
""") % (CASES, (SEQ, BATCH, STEPS, LR, SEED))


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    """The JAX side, from one subprocess with four host devices."""
    d = tmp_path_factory.mktemp("tp")
    np.savez(d / "in.npz", **{f"{name}/b{i}/{k}": v for name in CASES
                              for i, b in enumerate(_batches(name))
                              for k, v in b.items()})
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
    assert proc.returncode == 0 and "JAX-TP-OK" in proc.stdout, proc.stderr
    return dict(np.load(d / "out.npz"))


def _tree(out, prefix):
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


def _stacked(path, arrs):
    return np.stack(arrs) if path.startswith(("groups/", "encoder/")) \
        else arrs[0]


def _leaves(model):
    """{leaf path: numpy array, stacked as the JAX pytree}."""
    out = {}
    for path, ps in model.leaves().items():
        out[path] = _stacked(path, [p.numpy() if hasattr(p, "sharding")
                                    else p.detach().numpy() for p in ps])
    return out


def _placed(out, name, mesh, rules):
    cfg = _cfg(name)
    step, tx, shardings = build_train(cfg, mesh=mesh, rules=rules, lr=LR,
                                      total_steps=STEPS)
    (p_sh, o_sh, _), _ = shardings(mesh, rules)
    model = params_from_arrays(_tree(out, f"{name}/p0/"), cfg,
                               shardings=p_sh)
    return model, step, tx, p_sh


def _train(step, tx, model, batches):
    opt = tx.init(model.leaves())
    hist = []
    for b in batches:
        opt, m = step(model, opt, b)
        hist.append({k: (float(v) if isinstance(v, torch.Tensor) else v)
                     for k, v in m.items()})
    return hist


# ---------------------------------------------------------------------------
# (i) specs, constrain and the collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch, shape):
    """`resolve_spec` under `rules_for_cell`'s rules, and `named_sharding`
    of every leaf, against the JAX functions on a stand-in mesh of the
    same axes; `model_dim` names the dimension `model` splits."""
    assert list(ARCH_IDS) == list(JARCH_IDS)
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh = _mesh(*shape)
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": shape[0],
                                         "model": shape[1]})
    s = SHAPES["train_4k"]
    rules = rules_for_cell(mesh, cfg, s, settings_for(arch, s))
    jrules = jcells.rules_for_cell(jmesh, jcfg, s,
                                   jcells.settings_for(arch, s))
    assert rules == jrules
    jaxes = jparam_axes(jcfg)
    with jsharding.use_rules(jmesh, jrules):
        for path, ax in param_axes(cfg).items():
            node = jaxes
            for key in path.split("/"):
                node = node[key]
            assert tuple(node) == ax
            want = tuple(jsharding.resolve_spec(ax))
            assert resolve_spec(ax, rules) == want, path
            sh = named_sharding(mesh, rules, ax)
            assert sh.spec == want, path
            md = model_dim(sh, len(ax))
            assert (md is None) == ("model" not in want), path
            for logical in ("heads", "kv_heads", "d_ff", "vocab", "expert"):
                spec = (None, logical)
                assert resolve_spec(spec, rules) == tuple(
                    jsharding.resolve_spec(spec))


def test_constrain_is_the_identity_without_rules():
    """No rules: () as the JAX empty spec, and `constrain` returns its
    tensor; a tensor under rules over `model` 4 is returned as well (only
    `Parts` are split over `model`)."""
    x = torch.randn(2, 3, 8)
    assert resolve_spec(("batch", None, "d_ff")) == ()
    assert constrain(x, "batch", None, "d_ff") is x
    mesh = _mesh(1, 4)
    with sharding.use_rules(mesh, _rules("dense", mesh)):
        assert resolve_spec(("batch", None, "d_ff")) == ("data", None,
                                                         "model")
        assert constrain(x, "batch", None, "d_ff") is x


def _parts(ts, layout, rules, dtype=None):
    return Parts(ts, layout, positions=[(0, j) for j in range(len(ts))],
                 rules=rules, dtype=dtype)


def test_collectives_and_their_adjoints():
    """All-reduce: the float32 sum in model order, rounded to bf16 once,
    on every position; its backward gives each partial the sum of the
    copies' gradients. All-gather: the concat; its backward each slice
    the sum of its blocks. Scatter: each position's slice of its copy."""
    rules = _rules("dense", _mesh(1, 4))
    g = torch.Generator().manual_seed(0)
    ps = [torch.randn(3, 8, generator=g, requires_grad=True)
          for _ in range(4)]
    x = _parts(ps, "sum", rules, torch.bfloat16)
    whole = constrain(x, "batch", None, None)
    want = (ps[0] + ps[1] + ps[2] + ps[3]).detach().to(torch.bfloat16)
    assert whole.layout == "whole" and all(torch.equal(t, want)
                                           for t in whole)
    ws = [torch.randn(3, 8, generator=g).to(torch.bfloat16)
          for _ in range(4)]
    torch.autograd.backward(list(whole), ws)
    total = sum(w.float() for w in ws)
    assert all(torch.equal(p.grad, total) for p in ps)
    # all-gather over the last dimension, then scatter back to it
    ss = [torch.randn(3, 2, generator=g, requires_grad=True)
          for _ in range(4)]
    gathered = constrain(_parts(ss, 1, rules), "batch", "d_ff")
    assert gathered.layout == 1
    gathered = constrain(_parts(ss, 1, rules), "batch", None)
    cat = torch.cat([s.detach() for s in ss], 1)
    assert all(torch.equal(t, cat) for t in gathered)
    gs = [torch.randn(3, 8, generator=g) for _ in range(4)]
    torch.autograd.backward(list(gathered), gs)
    for j, s in enumerate(ss):
        want = sum(gg[:, 2 * j:2 * j + 2] for gg in gs)
        torch.testing.assert_close(s.grad, want, rtol=0, atol=1e-6)
    back = constrain(gathered, "batch", "d_ff")
    assert back.layout == 1 and all(torch.equal(t, cat[:, 2 * j:2 * j + 2])
                                    for j, t in enumerate(back))


# ---------------------------------------------------------------------------
# (ii) the tensor-parallel trainer against the JAX trainer
# ---------------------------------------------------------------------------


def _check_against_jax(out, name, shape, model, hist):
    tag = f"{name}/{shape[0]}x{shape[1]}"
    for i, h in enumerate(hist):
        assert h["loss"] == pytest.approx(float(out[f"{tag}/loss{i}"]),
                                          rel=1e-4), (tag, i)
        assert h["grad_norm"] == pytest.approx(
            float(out[f"{tag}/gnorm{i}"]), rel=2e-3), (tag, i)
    if name == "moe":
        return          # the later step routes by each framework's logits
    p0, pN = _tree(out, f"{name}/p0/"), _tree(out, f"{tag}/p{STEPS}/")
    for path, got in _leaves(model).items():
        start = _node(p0, path)
        change = _node(pN, path) - start
        off = np.abs(got - start - change) > 0.05 * np.abs(change).max()
        assert off.sum() <= max(0.02 * off.size, 4), (tag, path, off.sum())


def _check_moe_grads(out, name, shape, routes, first, monkeypatch):
    """Every leaf's gradient at the first update against the JAX
    gradient of the whole batch (tests/test_torch_fsdp.py's check, within
    3e-2 of the leaf's largest), the JAX MoE layers routed as the port's
    routed: each model position routes by its own copy of the router,
    and the copies must agree."""
    assert fsdp_tests.CASES[name] == CASES[name][:3]
    data, M = shape
    calls = routes[:first["routes"]]
    assert calls and len(calls) % M == 0
    calls = [calls[i:i + M] for i in range(0, len(calls), M)]
    assert all(torch.equal(c[0], t) for c in calls for t in c[1:])
    cfg = _cfg(name)
    layers = cfg.n_groups * sum(spec.moe for spec in cfg.group_spec)
    topis = fsdp_tests._batch_routes([c[0] for c in calls], data, layers)
    batch = {k: v for k, v in _batches(name)[0].items() if k != "aux"}
    want = fsdp_tests._jax_first_grads(out, name, batch, topis, monkeypatch)
    assert set(first["grads"]) == set(want)
    for path, got in first["grads"].items():
        scale = max(float(np.abs(want[path]).max()), 1e-30)
        np.testing.assert_allclose(got / scale, want[path] / scale, rtol=0,
                                   atol=3e-2, err_msg=path)


@pytest.mark.parametrize("name,shape", RUNS)
def test_tp_step_matches_jax(jax_tp, name, shape, monkeypatch):
    """Two steps of the (data, model) step from the JAX initial
    parameters against the JAX steps on the same mesh: losses, grad
    norms, every leaf's change (MoE: every leaf's step-0 gradient,
    `_check_moe_grads`); each position holding 1/M of every model-split
    leaf; the flash calls' head counts by position."""
    out = jax_tp
    cfg, mesh = _cfg(name), _mesh(*shape)
    rules = _rules(name, mesh)
    routes: list = []
    first = (fsdp_tests._first_update(monkeypatch, routes)
             if name == "moe" else None)
    model, step, tx, _ = _placed(out, name, mesh, rules)
    M = shape[1]
    for nm, p in model.placed.items():
        md = model_dim(p.sharding, p.ndim)
        for j in range(M):       # each slice once over the data shards
            held = {p.sharding.index(pos, p.ndim): t.numel()
                    for pos, t in p.positions() if pos[1] == j}
            whole = int(np.prod(p.shape))
            assert sum(held.values()) * (M if md is not None else 1) == \
                whole, nm
    hist = _train(step, tx, model, _batches(name))
    _check_against_jax(out, name, shape, model, hist)
    if first is not None:
        _check_moe_grads(out, name, shape, routes, first, monkeypatch)
    assert len(hist[0]["launches_by_shard"]) == len(hist[0][
        "heads_by_shard"]) == shape[0] * M
    if cfg.attn_impl == "flash":
        hq = cfg.n_heads // M if cfg.n_heads % M == 0 else cfg.n_heads
        for heads in hist[0]["heads_by_shard"]:
            assert heads and {h[1] for h in heads} == {hq}, heads


def test_run_over_2x2_matches_jax(jax_tp, tmp_path):
    """`launch.train.run(mesh=(2, 2))` against the JAX steps."""
    out = jax_tp
    mesh = _mesh(2, 2)
    rules = _rules("dense", mesh)
    model, _, _, _ = _placed(out, "dense", mesh, rules)
    hist = run(_cfg("dense"), steps=STEPS, batch=BATCH, seq=SEQ, lr=LR,
               seed=SEED, params=model, mesh=mesh, rules=rules,
               ckpt_dir=str(tmp_path), save_every=100, log=lambda m: None)
    _check_against_jax(out, "dense", (2, 2), model, hist)


@pytest.mark.parametrize("name,shape", [r for r in RUNS if r[0] != "moe"])
def test_tp_step_matches_unsharded(jax_tp, name, shape):
    """The same two steps against the port's unsharded trainer at
    microbatches = data shards, from the same weights."""
    out = jax_tp
    cfg, mesh = _cfg(name), _mesh(*shape)
    model, step, tx, _ = _placed(out, name, mesh, _rules(name, mesh))
    ref_model = params_from_arrays(_tree(out, f"{name}/p0/"), cfg,
                                   device="cpu")
    ref_step, ref_tx, _ = build_train(cfg, shape[0], lr=LR,
                                      total_steps=STEPS)
    batches = _batches(name)
    ref = _train(ref_step, ref_tx, ref_model, batches)
    hist = _train(step, tx, model, batches)
    for a, b in zip(ref, hist, strict=True):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=2e-3)
    want = _leaves(ref_model)
    for path, got in _leaves(model).items():
        np.testing.assert_allclose(got, want[path], rtol=0, atol=2e-4,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# (iii) protected checkpoints restored onto other meshes
# ---------------------------------------------------------------------------


def test_protected_restore_onto_other_meshes(jax_tp, tmp_path):
    """A (2, 2) run saves an NB-LDPC-protected checkpoint at step 1,
    storage faults are injected into it, and it comes back onto (2, 2),
    (4, 1) and no mesh: every leaf bit for bit, corrections made."""
    out = jax_tp
    cfg = _cfg("dense")
    mesh = _mesh(2, 2)
    rules = _rules("dense", mesh)
    model, _, tx, _ = _placed(out, "dense", mesh, rules)
    d = str(tmp_path / "ck")
    run(cfg, steps=2, batch=BATCH, seq=SEQ, lr=LR, seed=SEED, params=model,
        mesh=mesh, rules=rules, ckpt_dir=d, save_every=1, protect=True,
        log=lambda m: None)
    assert ckpt.inject_storage_faults(d, uniform_flip(3, 1e-4), key=SEED,
                                      device=CPU) > 0
    trained = _leaves(model)
    n = {"groups": cfg.n_groups}
    axes = {p: [layer_axes(p, ax)] * n.get(p.split("/")[0], 1)
            for p, ax in param_axes(cfg).items()}
    for target in ((2, 2), (4, 1), None):
        if target is None:
            template = {"params": model.gather(CPU).leaves()}
            got, manifest = ckpt.restore_checkpoint(d, template, device=CPU)
        else:
            m2 = _mesh(*target)
            sh = elastic_shardings(m2, _rules("dense", m2), {
                "params": axes, "opt": {"m": axes, "v": axes,
                                        "step": None}})
            template = {"params": model.leaves(),
                        "opt": optim.adamw(1.0).init(model.leaves())}
            got, manifest = ckpt.restore_checkpoint(d, template,
                                                    shardings=sh, device=CPU)
            assert all(p.sharding.mesh is m2 for ps in got[
                "params"].values() for p in ps)
        assert manifest["correction_stats"]["corrected"] > 0
        for path, ps in got["params"].items():
            arr = _stacked(path, [p.numpy() if hasattr(p, "sharding")
                                  else p.detach().numpy() for p in ps])
            assert np.array_equal(arr, trained[path]), (target, path)
