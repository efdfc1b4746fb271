"""Port parity: context parallelism over `data` and the `pod` axis
against the JAX package on the CPU.

The port's meshes name the CPU several times ((2, 2), (2, 4) `data` x
`model` and (2, 2, 2) `pod` x `data` x `model` meshes of one process);
the JAX side runs once, in one subprocess with eight forced host
devices: `build_prefill` and `build_serve` jitted with `rules_for_cell`'s
shardings of a `long_500k` cell (the batch whole, the KV sequence over
`data`, and `pod`, and over `model` where the KV heads do not divide
it) on `compat_make_mesh`, fed numpy prompts (4 x 16 tokens) and four
decode tokens against 24-deep caches; `build_serve` under a decode
cell's rules on the pod mesh (the batch over `("pod", "data")`); and
`build_train` on the pod mesh for two steps. Its initial parameters
(precoded for `paper_pim`) and its prefill caches are carried onto the
port's mesh (`convert.params_from_arrays(shardings=...)`,
`convert.caches_from_arrays(mesh=...)`). The serving cases:

- "dense": reduced granite-3-2b with 2 KV heads: on (2, 2) the rows
  over `data` and the KV heads over `model`; on (2, 4) the rows over
  `data` and `model` (2 heads over 4 positions); on (2, 2, 2) over
  `("pod", "data")`;
- "rings": reduced gemma2-27b (a sliding layer of window 8 beside a
  global one, softcaps) on (2, 2): the ring split over the data shards,
  the prompt longer than the window and the decode wrapping it;
- "mamba": reduced falcon-mamba-7b on (2, 2): no KV, its states
  replicated over `data`;
- "hybrid": one reduced jamba-v0.1-52b block (mamba, attention and MoE
  layers) on (2, 2), each replica dispatching the whole batch, at a
  capacity that drops no slot;
- "pim": reduced paper_pim precoded on wl40_r08 on (2, 2), `wo` and
  `w_down` on the row-parallel protected path.

Tolerances (tests/test_torch_tp_serve.py's and tests/test_torch_tp.py's):

- `rules_for`, `RULES_MULTI_POD`, `use_rules`' default and
  `rules_for_cell` of every config and shape equal to the JAX package's
  on (2, 2), (4, 1), (2, 4) and (2, 2, 2);
- logits within LOGITS_ATOL of the JAX logits, greedy tokens equal
  where the JAX top-2 margin is above twice that, caches within one
  bf16 ulp of each entry's largest magnitude; with PIM, the PIM bounds;
  in the hybrid case a row a router near-tie touched may differ (at
  most one), and its caches, which take the outputs of its MoE and
  mamba layers, are held within two ulps of each entry's largest
  magnitude (measured 1.5, in one element of 2,048);
- every data shard's logits equal bit for bit (the replicas), and the
  PIM counts equal to the port's unsharded run's;
- training on the pod mesh: each step's loss within 1e-4 relative of
  the JAX step's and its grad norm within 2e-3;
- a block of KV rows with no visible row weighs 0, without NaN; a mesh
  axis no rule names raises.
"""
import inspect
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.launch import cells as jcells
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import caches_from_arrays, params_from_arrays
from repro_torch.core.context import PIMContext
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.distributed import (RULES_MULTI_POD, RULES_SINGLE_POD,
                                     rules_for, use_rules)
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Mesh, lse_merge
from repro_torch.launch.cells import rules_for_cell, settings_for
from repro_torch.launch.steps import build_prefill, build_serve, build_train
from repro_torch.models import init_caches, init_params
from repro_torch.models.lm import encode_params_for_pim, place_params
from repro_torch.nn.layers import _partial_softmax
from _torch_threads import torch_threads_per_worker  # noqa: F401
from test_torch_tp_serve import (LOGITS_ATOL, NEAR_TIE_ULPS, PIM_ATOL,
                                 _check_caches, _check_logits, _check_tokens,
                                 _np, _tree, _ulp, make_cfg)

CPU = torch.device("cpu")
B, S, T, DEEP, SEED = 4, 16, 4, 24, 0
_DENSE = dict(n_groups=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
# name: (arch, reduced kw, replaced fields, meshes)
CASES = {
    "dense": ("granite_3_2b", _DENSE, {}, [(2, 2), (2, 4), (2, 2, 2)]),
    "rings": ("gemma2_27b", _DENSE, {"window": 8}, [(2, 2)]),
    "mamba": ("falcon_mamba_7b", dict(n_groups=2, d_model=64, n_heads=4,
                                      d_ff=0), {}, [(2, 2)]),
    "hybrid": ("jamba_v01_52b", dict(n_groups=1, d_model=64, n_heads=4,
                                     n_kv_heads=2, d_ff=128, n_experts=4),
               {"top_k": 2, "capacity_factor": 8.0}, [(2, 2)]),
    "pim": ("paper_pim", dict(n_groups=2, d_model=64, n_heads=4,
                              n_kv_heads=4, d_ff=128),
            {"pim": {"code_name": "wl40_r08", "precoded": True}}, [(2, 2)]),
}
RUNS = [(name, shape) for name, case in CASES.items() for shape in case[3]]
POD = (2, 2, 2)
LONG = ShapeSpec("long_500k", DEEP, B, "decode")
DECODE = ShapeSpec("custom", DEEP, B, "decode")
TRAIN = ShapeSpec("custom", 32, B, "train")
TRAIN_STEPS, LR = 2, 1e-3
RULE_MESHES = [(2, 2), (4, 1), (2, 4), POD]


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _mesh(shape):
    return Mesh(np.full(shape, CPU, dtype=object), _axes(shape))


def _tag(shape):
    return "x".join(map(str, shape))


def _cfg(name):
    arch, kw, extra, _ = CASES[name]
    return make_cfg(get_config, arch, kw, extra)


def _rules(name, mesh, shape):
    return rules_for_cell(mesh, _cfg(name), shape,
                          settings_for(CASES[name][0], shape))


def _inputs(name):
    cfg = _cfg(name)
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "toks": rng.integers(0, cfg.vocab_size, (T, B, 1))}


def _batches():
    cfg = _cfg("dense")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN.seq_len, global_batch=B,
                                    seed=SEED))
    return [dict(next(pipe)) for _ in range(TRAIN_STEPS)]


_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np
    assert len(jax.devices()) == 8, jax.devices()
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.distributed.sharding import use_rules
    from repro.launch.cells import rules_for_cell, settings_for
    from repro.launch.mesh import compat_make_mesh
    from repro.launch.steps import build_prefill, build_serve, build_train
    from repro.models import encode_params_for_pim, init_params
    from repro.models.lm import init_caches

    CASES = %r
    B, S, T, DEEP, SEED, POD, TRAIN_STEPS, LR = %r
    inp = np.load(sys.argv[1])
    %s

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}" if prefix else k))
            return out
        a = tree
        if jnp.issubdtype(a.dtype, jnp.floating):
            a = a.astype(jnp.float32)
        return {prefix: np.asarray(a)}


    def axes(ms):
        return ("data", "model") if len(ms) == 2 else ("pod", "data",
                                                       "model")


    out = {}
    long = ShapeSpec("long_500k", DEEP, B, "decode")
    decode = ShapeSpec("custom", DEEP, B, "decode")
    for name, (arch, kw, extra, meshes) in CASES.items():
        cfg = make_cfg(get_config, arch, kw, extra)
        p0 = init_params(jax.random.PRNGKey(SEED), cfg)
        if cfg.pim.enabled and cfg.pim.precoded:
            p0 = encode_params_for_pim(p0, cfg)
        for path, a in flat(p0).items():
            out[f"{name}/p0/{path}"] = a
        batch = {"tokens": jnp.asarray(inp[f"{name}/tokens"], jnp.int32)}
        full = init_caches(cfg, B, DEEP)
        runs = [(ms, long) for ms in meshes]
        if name == "dense":
            runs.append((POD, decode))
        for ms, shape in runs:
            tag = f"{name}/{shape.name}/{'x'.join(map(str, ms))}"
            mesh = compat_make_mesh(ms, axes(ms))
            rules = rules_for_cell(mesh, cfg, shape, settings_for(arch,
                                                                  shape))
            step, _, shardings = build_prefill(cfg, shape)
            in_sh, out_sh = shardings(mesh, rules)
            with use_rules(mesh, rules):
                params = jax.device_put(p0, in_sh[0])
                logits, caches = jax.jit(step, in_shardings=in_sh,
                                         out_shardings=out_sh)(params, batch)
            out[f"{tag}/prefill_logits"] = np.asarray(logits)
            for path, a in flat(caches).items():
                out[f"{tag}/prefill_caches/{path}"] = a
            # the prompt's caches in DEEP buffers (rings stay W long)
            caches = jax.tree.map(
                lambda c, f: jnp.pad(c, [(0, 0), (0, 0),
                                         (0, f.shape[2] - c.shape[2])]
                                     + [(0, 0)] * (c.ndim - 3)),
                caches, full)
            step, _, shardings = build_serve(cfg, shape)
            in_sh, out_sh = shardings(mesh, rules)
            with use_rules(mesh, rules):
                params = jax.device_put(p0, in_sh[0])
                caches = jax.device_put(caches, in_sh[1])
                serve = jax.jit(step, in_shardings=in_sh,
                                out_shardings=out_sh)
                for i in range(T):
                    b = {"tokens": jnp.asarray(inp[f"{name}/toks"][i],
                                               jnp.int32),
                         "pos": jnp.asarray(S + i, jnp.int32)}
                    logits, caches = serve(params, caches, b)
                    out[f"{tag}/decode_logits{i}"] = np.asarray(logits)
            for path, a in flat(caches).items():
                out[f"{tag}/decode_caches/{path}"] = a

    # training on the pod mesh
    arch, kw, extra, _ = CASES["dense"]
    cfg = make_cfg(get_config, arch, kw, extra)
    shape = ShapeSpec("custom", inp["train/b0/tokens"].shape[1], B, "train")
    st = dataclasses.replace(settings_for(arch, shape), microbatches=1)
    mesh = compat_make_mesh(POD, axes(POD))
    rules = rules_for_cell(mesh, cfg, shape, st)
    step, _, shardings, tx = build_train(cfg, st, shape, lr=LR,
                                         total_steps=TRAIN_STEPS)
    in_sh, out_sh = shardings(mesh, rules)
    p0 = init_params(jax.random.PRNGKey(SEED), cfg)
    params = jax.device_put(p0, in_sh[0])
    opt = jax.device_put(tx.init(p0), in_sh[1])
    jstep = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
    with use_rules(mesh, rules):
        for i in range(TRAIN_STEPS):
            b = {k: jnp.asarray(inp[f"train/b{i}/{k}"])
                 for k in ("tokens", "labels")}
            params, opt, m = jstep(params, opt, b)
            out[f"train/loss{i}"] = np.asarray(m["loss"])
            out[f"train/gnorm{i}"] = np.asarray(m["grad_norm"])
    np.savez(sys.argv[2], **out)
    print("JAX-CP-SERVE-OK")
""") % (CASES, (B, S, T, DEEP, SEED, POD, TRAIN_STEPS, LR),
        textwrap.indent(inspect.getsource(make_cfg), "    ").lstrip())


@pytest.fixture(scope="module")
def jax_cp(tmp_path_factory):
    """The JAX side, from one subprocess with eight host devices."""
    d = tmp_path_factory.mktemp("cp_serve")
    arrays = {f"{name}/{k}": v for name in CASES
              for k, v in _inputs(name).items()}
    arrays.update({f"train/b{i}/{k}": v for i, b in enumerate(_batches())
                   for k, v in b.items()})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                           str(d / "in.npz"), str(d / "out.npz")],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0 and "JAX-CP-SERVE-OK" in proc.stdout, \
        proc.stderr
    return dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# (i) the rules
# ---------------------------------------------------------------------------


def _jmesh(shape):
    """A stand-in JAX mesh: the rule functions read only its axes."""
    axes = _axes(shape)
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))


@pytest.mark.parametrize("shape", RULE_MESHES, ids=_tag)
def test_rules_for_and_use_rules_default_match_jax(shape):
    """`RULES_SINGLE_POD`, `RULES_MULTI_POD`, `rules_for` (with and
    without `seq_sharded_kv`) and the rules `use_rules(mesh)` makes
    ambient equal the JAX package's."""
    assert RULES_SINGLE_POD == jsharding.RULES_SINGLE_POD
    assert RULES_MULTI_POD == jsharding.RULES_MULTI_POD
    mesh, jmesh = _mesh(shape), _jmesh(shape)
    for kv in (False, True):
        assert rules_for(mesh, seq_sharded_kv=kv) == jsharding.rules_for(
            jmesh, seq_sharded_kv=kv)
    with use_rules(mesh):
        got = sharding.active_rules()
    with jsharding.use_rules(jmesh):
        want = jsharding._CTX.state[1]
    assert got == want == jsharding.rules_for(jmesh)


@pytest.mark.parametrize("shape", RULE_MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_for_cell_matches_jax(arch, shape):
    """`rules_for_cell` of every shape (the multi-pod table on a pod
    mesh, `long_500k`'s context parallelism) against the JAX function on
    a stand-in mesh of the same axes; a step lays its data shards out
    by them (`ShardLayout`): `long_500k`'s shards all replicas, each
    holding its block of the KV rows."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh, jmesh = _mesh(shape), _jmesh(shape)
    for name, s in SHAPES.items():
        st, jst = settings_for(arch, s), jcells.settings_for(arch, JSHAPES[
            name])
        rules = rules_for_cell(mesh, cfg, s, st)
        assert rules == jcells.rules_for_cell(jmesh, jcfg, JSHAPES[name],
                                              jst), name
        layout = sharding.ShardLayout(mesh, rules)
        n = int(np.prod(shape[:-1]))
        assert len(layout) == n
        if name == "long_500k":
            assert layout.row_blocks == 1 and layout.replica == list(
                range(n))
            assert layout.kv_count == n * (1 if rules["kv_heads"]
                                           else shape[-1])
        else:
            assert layout.row == list(range(n)) and not layout.replicated


# ---------------------------------------------------------------------------
# (ii) prefill and decode against the JAX steps
# ---------------------------------------------------------------------------


def _placed(out, name, mesh, rules):
    cfg = _cfg(name)
    (p_sh, _), _ = build_prefill(cfg)[1](mesh, rules)
    return params_from_arrays(_tree(out, f"{name}/p0/"), cfg,
                              shardings=p_sh)


def _margins(monkeypatch):
    """Each `topk_route` call's K-th minus (K+1)-th router logit in bf16
    ulps of the row's largest (tests/test_torch_tp_serve.py's record)."""
    from repro_torch.nn import moe
    margins = []
    route = moe.topk_route

    def recording(logits, k):
        top = torch.sort(logits, dim=-1, descending=True)[0]
        ulp = torch.finfo(torch.bfloat16).eps * logits.abs().amax(-1)
        margins.append(((top[:, k - 1] - top[:, k]) / ulp.clamp_min(
            torch.finfo(torch.bfloat16).tiny)).numpy())
        return route(logits, k)
    monkeypatch.setattr(moe, "topk_route", recording)
    return margins


def _tied(margins) -> np.ndarray:
    """(B,) bool: a row one of whose tokens had a router near-tie in a
    call (every replica routes the whole batch)."""
    if not margins:
        return np.zeros(B, dtype=bool)
    tied = np.zeros(B, dtype=bool)
    for m in margins:
        tied |= (m < NEAR_TIE_ULPS).reshape(B, -1).any(-1)
    margins.clear()
    return tied


def _held_caches(got, want, tag, cfg, rows):
    """`_check_caches`; the hybrid's entries within two ulps."""
    if not cfg.n_experts:
        return _check_caches(got, want, tag, cfg, rows)
    rows = slice(None) if rows is None else rows
    for pos, e in want.items():
        for nm, arr in e.items():
            np.testing.assert_allclose(_np(got[pos][nm])[:, rows],
                                       arr[:, rows], rtol=0,
                                       atol=2 * _ulp(arr),
                                       err_msg=f"{tag} {pos}/{nm}")


def _replicas_equal(step):
    got = step.shards.by_shard
    assert len(got) > 1 and all(torch.equal(g.cpu(), got[0].cpu())
                                for g in got), "replicas' logits differ"


def _serve_against_jax(out, name, shape, cell, monkeypatch):
    cfg, mesh = _cfg(name), _mesh(shape)
    tag = f"{name}/{cell.name}/{_tag(shape)}"
    inp = _inputs(name)
    rules = _rules(name, mesh, cell)
    model = _placed(out, name, mesh, rules)
    margins = _margins(monkeypatch) if cfg.n_experts else []
    off = np.zeros(B, dtype=bool) if cfg.n_experts else None
    tied = np.zeros(B, dtype=bool)
    pf, _ = build_prefill(cfg, mesh=mesh, rules=rules)
    logits, caches = pf(model, {"tokens": inp["tokens"]})
    whole = cell.name == "long_500k"
    if whole:
        _replicas_equal(pf)
    tied |= _tied(margins)
    _check_logits(_np(logits), out[f"{tag}/prefill_logits"], cfg, tag,
                  tied, off)
    held = None if off is None else ~off
    _held_caches(caches, _tree(out, f"{tag}/prefill_caches/"), tag, cfg,
                 held)
    want_shapes = init_caches(cfg, B, DEEP, device="meta")
    padded = {pos: {nm: np.pad(a, [(0, 0), (0, 0), (0, want_shapes[pos][
        nm].shape[2] - a.shape[2])] + [(0, 0)] * (a.ndim - 3))
        for nm, a in e.items()}
        for pos, e in _tree(out, f"{tag}/prefill_caches/").items()}
    caches = caches_from_arrays(cfg, padded, mesh=mesh, rules=rules)
    sv, _ = build_serve(cfg, B, DEEP, mesh=mesh, rules=rules)
    got, want = [], []
    for i in range(T):
        lg, caches = sv(model, caches, {"tokens": inp["toks"][i],
                                        "pos": S + i})
        if whole:
            _replicas_equal(sv)
        tied |= _tied(margins)
        got.append(_np(lg))
        want.append(out[f"{tag}/decode_logits{i}"])
        _check_logits(got[-1], want[-1], cfg, f"{tag} step {i}", tied, off)
    rows = slice(None) if off is None else ~off
    _check_tokens(np.concatenate([g[rows] for g in got]),
                  np.concatenate([w[rows] for w in want]),
                  PIM_ATOL if cfg.pim.enabled else LOGITS_ATOL)
    _held_caches(caches, _tree(out, f"{tag}/decode_caches/"), tag, cfg,
                 None if off is None else ~off)
    return caches


@pytest.mark.parametrize("name,shape", RUNS,
                         ids=[f"{n}-{_tag(s)}" for n, s in RUNS])
def test_cp_serving_matches_jax(jax_cp, name, shape, monkeypatch):
    """The port's `build_prefill` and `build_serve` under a `long_500k`
    cell's rules against the JAX steps on the same mesh and rules: the
    prefill's logits and caches, then four decode steps from the JAX
    prefill's caches (logits, greedy tokens, the caches after them),
    every data shard's logits equal bit for bit; each position holding
    its block of the KV rows."""
    caches = _serve_against_jax(jax_cp, name, shape, LONG, monkeypatch)
    cfg, mesh = _cfg(name), _mesh(shape)
    rules = _rules(name, mesh, LONG)
    layout = sharding.ShardLayout(mesh, rules)
    for e in caches.values():
        for nm, p in e.items():
            if nm in ("k", "v"):
                assert p.sharding.parts(p.ndim)[2] == layout.kv_count > 1
                held = {p.sharding.index(pos, p.ndim)[2]
                        for pos, _t in p.positions()}
                assert held == set(range(layout.kv_count))


def test_pod_decode_matches_jax(jax_cp, monkeypatch):
    """A decode cell's rules on the (2, 2, 2) pod mesh: the batch over
    `("pod", "data")`, one row a data shard pod-major, against the JAX
    steps."""
    _serve_against_jax(jax_cp, "dense", POD, DECODE, monkeypatch)


def test_pod_train_matches_jax(jax_cp):
    """`build_train` on the (2, 2, 2) pod mesh (the batch over `("pod",
    "data")`, FSDP over `data`, the parameters replicated over `pod`):
    two steps' losses and grad norms against the JAX steps; and the
    port's unsharded trainer at four microbatches."""
    cfg = _cfg("dense")
    mesh = _mesh(POD)
    st = settings_for("granite_3_2b", TRAIN)
    rules = rules_for_cell(mesh, cfg, TRAIN, st)
    assert rules["batch"] == ("pod", "data") and rules["fsdp"] == "data"
    step, tx, shardings = build_train(cfg, mesh=mesh, rules=rules, lr=LR,
                                      total_steps=TRAIN_STEPS)
    (p_sh, _, _), _ = shardings(mesh, rules)
    model = params_from_arrays(_tree(jax_cp, "dense/p0/"), cfg,
                               shardings=p_sh)
    ref_model = model.gather(CPU)
    opt = tx.init(model.leaves())
    ref_step, ref_tx, _ = build_train(cfg, 4, lr=LR, total_steps=TRAIN_STEPS)
    ref_opt = ref_tx.init(ref_model.leaves())
    for i, b in enumerate(_batches()):
        opt, m = step(model, opt, b)
        ref_opt, rm = ref_step(ref_model, ref_opt, b)
        assert len(m["launches_by_shard"]) == 8
        for got, want in ((float(m["loss"]), float(jax_cp[f"train/loss{i}"])),
                          (float(m["loss"]), float(rm["loss"]))):
            assert got == pytest.approx(want, rel=1e-4), i
        for got, want in ((float(m["grad_norm"]),
                           float(jax_cp[f"train/gnorm{i}"])),
                          (float(m["grad_norm"]), float(rm["grad_norm"]))):
            assert got == pytest.approx(want, rel=2e-3), i


# ---------------------------------------------------------------------------
# (iii) against the port's unsharded serving
# ---------------------------------------------------------------------------


def _serve(cfg, model, inp, deep, *, mesh=None, rules=None, ctx=None):
    """The prefill and T decode steps: (prefill logits, steps' logits,
    caches, the serve step)."""
    pf, _ = build_prefill(cfg, mesh=mesh, rules=rules, pim_ctx=ctx)
    sv, _ = build_serve(cfg, B, deep, mesh=mesh, rules=rules, pim_ctx=ctx)
    lg, caches = pf(model, {"tokens": inp["tokens"]}, max_seq=deep)
    if mesh is None:
        pre, caches = caches, init_caches(cfg, B, deep, device="cpu")
        for pos, e in pre.items():
            for nm, val in e.items():
                caches[pos][nm][:, :, :val.shape[2]] = val
    steps = []
    for i in range(T):
        steps.append(sv(model, caches, {"tokens": inp["toks"][i],
                                        "pos": S + i})[0])
        if mesh is not None:
            _replicas_equal(sv)
    return lg, torch.cat(steps, 1), caches, sv


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (2, 1, 2)], ids=_tag)
def test_cp_pim_counts_match_unsharded(shape, faults):
    """Precoded paper_pim under `long_500k` rules, fault-free and with
    PIM output errors and weight flips: the PIM counts equal the
    unsharded run's (replicas count nothing, and draw the faults the
    unsharded call draws), the prefill's logits bit for bit, the decode
    within the PIM bounds."""
    cfg = _cfg("pim")
    model = init_params(cfg, SEED, device="cpu")
    encode_params_for_pim(model, cfg)
    inp = _inputs("pim")

    def context():
        c = PIMContext(cfg.pim)
        return c.with_faults(3, 2e-3, 1e-4) if faults else c
    ref = context()
    lg, steps, _, _ = _serve(cfg, model, inp, DEEP, ctx=ref)
    mesh = _mesh(shape)
    rules = _rules("pim", mesh, LONG)
    (p_sh, _), _ = build_prefill(cfg)[1](mesh, rules)
    ctx = context()
    tlg, tsteps, _, _ = _serve(cfg, place_params(model, p_sh), inp, DEEP,
                               mesh=mesh, rules=rules, ctx=ctx)
    assert ctx.stats() == ref.stats() and ref.stats()["words"] > 0
    assert ref.stats()["detected_words"] > 0 or not faults
    assert torch.equal(tlg, lg)
    d = (tsteps - steps).abs()
    assert float(d.max()) <= PIM_ATOL


def test_fully_masked_blocks_weigh_nothing():
    """A prompt of 16 tokens in caches 64 deep over (4, 1): the last two
    data shards hold no visible row through the decode (m = NEG_INF,
    l = their row count), yet the logits stay finite and within
    LOGITS_ATOL of the unsharded run's; `lse_merge` gives such a part
    exactly zero weight: the merge equals the visible part's own
    softmax, bit for bit."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 1, 4, 8, generator=g).to(torch.bfloat16)
    k = torch.randn(1, 6, 2, 8, generator=g).to(torch.bfloat16)
    v = torch.randn(1, 6, 2, 8, generator=g).to(torch.bfloat16)
    live = torch.tensor([True, True, False, True, False, True])
    dead = torch.zeros(6, dtype=torch.bool)
    ms = _partial_softmax(q, k, v, dead, 0.0)
    assert torch.all(ms[0] == -1e30) and torch.all(ms[1] == 6)
    own = _partial_softmax(q, k, v, live, 0.0)
    for parts in ([ms, own], [own, ms], [ms, own, ms]):
        got = lse_merge(parts)
        assert torch.isfinite(got).all()
        assert torch.equal(got, own[2] / own[1])
    cfg = _cfg("dense")
    model = init_params(cfg, SEED, device="cpu")
    inp = _inputs("dense")
    deep = 64
    lg, steps, _, _ = _serve(cfg, model, inp, deep)
    mesh = _mesh((4, 1))
    rules = _rules("dense", mesh, LONG)
    (p_sh, _), _ = build_prefill(cfg)[1](mesh, rules)
    tlg, tsteps, _, _ = _serve(cfg, place_params(model, p_sh), inp, deep,
                               mesh=mesh, rules=rules)
    assert torch.isfinite(tsteps).all()
    torch.testing.assert_close(tlg, lg, rtol=0, atol=LOGITS_ATOL)
    torch.testing.assert_close(tsteps, steps, rtol=0, atol=LOGITS_ATOL)


def test_unnamed_mesh_axis_raises():
    """A third mesh axis that no rule names (not `pod`, `data` or
    `model`) raises in every step's layout, never runs at its first
    position alone."""
    cfg = _cfg("dense")
    mesh = Mesh(np.full((2, 2, 2), CPU, dtype=object),
                ("replica", "data", "model"))
    rules = rules_for_cell(mesh, cfg, LONG, settings_for("granite_3_2b",
                                                         LONG))
    for build in (lambda: build_prefill(cfg, mesh=mesh, rules=rules),
                  lambda: build_serve(cfg, B, DEEP, mesh=mesh, rules=rules),
                  lambda: build_train(cfg, mesh=mesh, rules=dict(
                      rules, batch="data"))):
        with pytest.raises(ValueError, match="no rule names"):
            build()
    with pytest.raises(ValueError, match="no rule names"):
        sharding.shard_positions(mesh)
