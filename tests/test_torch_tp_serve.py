"""Port parity: tensor-parallel serving over a (data, model) mesh against
the JAX package on the CPU.

The port's meshes name the CPU several times ((2, 2) and (1, 4) `data`
x `model` meshes of one process); the JAX side runs once, in one
subprocess with eight forced host devices: `build_prefill` and
`build_serve` jitted with `rules_for_cell`'s shardings (a prefill cell's
rules for the prefill, a decode cell's for the decode: the KV sequence
over `model` where the KV heads do not divide it) on
`compat_make_mesh((2, 2))` / `((1, 4))` under `use_rules`, fed numpy
prompts (4 x 12 tokens), four decode tokens and aux embeddings where the
config takes them. Its initial parameters (precoded for `paper_pim`)
are carried onto the port's mesh by `convert.params_from_arrays(
shardings=...)`, and its prefill caches, padded to 16 rows, by
`convert.caches_from_arrays(mesh=...)`, so each decode starts from the
same caches. The cases:

- "dense": reduced granite-3-2b with 2 KV heads: split over `model` on
  (2, 2), on the KV sequence on (1, 4) (2 heads over 4 positions);
- "rings": reduced gemma2-27b (a sliding layer of window 8 beside a
  global one, softcaps) on (1, 4): the ring split over the sequence,
  the prompt longer than the window and the decode wrapping the ring;
- "moe": reduced olmoe-1b-7b (8 experts, top 2) on (2, 2), dispatched
  over the data shards at a capacity that drops no slot, so that a
  router near-tie moves only its own token (the whole batch's decode
  capacity, which drops slots, is held bit for bit against the
  unsharded decode with a `model` axis of 1: "moe_drops");
- "mamba": reduced falcon-mamba-7b on (2, 2), `d_inner` and the
  carried states over `model`;
- "encdec": reduced whisper-small (encoder, cross K/V cached) on (1, 4);
- "pim": reduced paper_pim precoded on wl40_r08, `wo` and `w_down` on
  the row-parallel protected path, on (1, 4) and (2, 2).

Tolerances:

- `rules_for_cell` / `settings_for` of every config and shape, and
  `cache_axes` / `pim_param_axes`, equal to the JAX package's;
- logits within LOGITS_ATOL (tests/test_torch_serving.py's two bf16
  ulps at |logit| = 1) of the JAX logits; greedy tokens equal where the
  JAX logits' top-2 margin is above twice that; caches within one bf16
  ulp of each entry's largest magnitude. With PIM, the bound of
  tests/test_torch_pim_serving.py (2^-3 on the largest logit gap, 2^-5
  on the median; the caches' largest gap 2^-3 of the entry's largest
  magnitude, the median within an ulp). In the MoE case a row may differ
  once one of its tokens has had a router near-tie (K-th and (K+1)-th
  logit within 4 bf16 ulps of the row's largest) and at most one row
  may, as in tests/test_torch_archs.py; the caches of the other rows
  are held;
- the row-parallel protected matmul and a model's PIM counts exactly:
  equal bit for bit to the unsharded `PIMContext.matmul` on the same x,
  with output errors and weight flips, with an ADC clip whose row groups
  straddle positions, and in every mode;
- a `model` axis of 1 runs the unsharded prefill and decode bit for bit.
"""
import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import cells as jcells
from repro.models import cache_axes as jcache_axes
from repro.models import param_axes as jparam_axes
from repro.models import pim_param_axes as jpim_param_axes
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import caches_from_arrays, params_from_arrays
from repro_torch.core.context import PIMContext
from repro_torch.distributed.sharding import Mesh, Parts, model_dim
from repro_torch.kernels import build
from repro_torch.launch.cells import (fsdp_serve_for, rules_for_cell,
                                      settings_for)
from repro_torch.launch.steps import build_prefill, build_serve
from repro_torch.models import init_params
from repro_torch.models.lm import (cache_axes, encode_params_for_pim,
                                   param_axes, pim_param_axes, place_params)
from _torch_threads import torch_threads_per_worker  # noqa: F401

CPU = torch.device("cpu")
B, S, T, SEED = 4, 12, 4, 0
LOGITS_ATOL = 2 * 2 ** -7
# A protected projection quantizes its bf16 input to +-7 levels with one
# scale, so an ulp on an input at a rounding boundary moves a level and
# that row's outputs by a few percent: tests/test_torch_pim_serving.py's
# bound on the unsharded model against the JAX one, 2^-3 on the largest
# logit gap and 2^-5 on the median, holds here too.
PIM_ATOL, PIM_MEDIAN = 2 ** -3, 2 ** -5
NEAR_TIE_ULPS = 4
_DENSE = dict(n_groups=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
# name: (arch, reduced kw, replaced fields, meshes)
CASES = {
    "dense": ("granite_3_2b", _DENSE, {}, [(2, 2), (1, 4)]),
    "rings": ("gemma2_27b", _DENSE, {"window": 8}, [(1, 4)]),
    "moe": ("olmoe_1b_7b", dict(n_groups=2, d_model=64, n_heads=4,
                                n_kv_heads=4, d_ff=128, n_experts=8),
            {"top_k": 2, "capacity_factor": 8.0}, [(2, 2)]),
    "mamba": ("falcon_mamba_7b", dict(n_groups=2, d_model=64, n_heads=4,
                                      d_ff=0), {}, [(2, 2)]),
    "encdec": ("whisper_small", dict(n_groups=2, d_model=64, n_heads=4,
                                     d_ff=128), {}, [(1, 4)]),
    "pim": ("paper_pim", dict(n_groups=2, d_model=64, n_heads=4,
                              n_kv_heads=4, d_ff=128),
            {"pim": {"code_name": "wl40_r08", "precoded": True}},
            [(1, 4), (2, 2)]),
}
RUNS = [(name, shape) for name, case in CASES.items() for shape in case[3]]
# held against the port's unsharded serving only
PORT_CASES = {"moe_drops": ("olmoe_1b_7b", CASES["moe"][1], {"top_k": 2},
                            []),
              # experts beside a protected dense MLP: data shards in
              # lockstep threads (PIM) that dispatch as the whole batch
              "moe_pim": ("arctic_480b", CASES["moe"][1], {
                  "top_k": 2, "pim": {"enabled": True,
                                      "code_name": "wl40_r08",
                                      "precoded": True}}, [])}
PREFILL = ShapeSpec("custom", S, B, "prefill")
DECODE = ShapeSpec("custom", S + T, B, "decode")


def make_cfg(get_config, arch, kw, extra):
    """A case's config in either package: `reduced(**kw)`, then a
    sliding window ("window"), PIM fields ("pim") or other fields."""
    cfg = get_config(arch).reduced(**kw)
    extra = dict(extra)
    if "window" in extra:
        w = extra.pop("window")
        cfg = dataclasses.replace(cfg, group_spec=tuple(
            dataclasses.replace(s, local_window=w if s.local_window else 0)
            for s in cfg.group_spec))
    if "pim" in extra:
        cfg = dataclasses.replace(cfg, pim=dataclasses.replace(
            cfg.pim, **extra.pop("pim")))
    return dataclasses.replace(cfg, **extra)


def _cfg(name):
    arch, kw, extra, _ = {**CASES, **PORT_CASES}[name]
    return make_cfg(get_config, arch, kw, extra)


def _mesh(data, model):
    return Mesh(np.array([[CPU] * model] * data, dtype=object),
                ("data", "model"))


def _rules(name, mesh, shape):
    return rules_for_cell(mesh, _cfg(name), shape, settings_for(
        {**CASES, **PORT_CASES}[name][0], shape))


def _inputs(name):
    cfg = _cfg(name)
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "toks": rng.integers(0, cfg.vocab_size, (T, B, 1))}
    if cfg.aux_kind:
        out["aux"] = (0.1 * rng.normal(size=(
            B, cfg.n_aux_tokens, cfg.d_model))).astype(np.float32)
    return out


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
    from repro.launch.steps import build_prefill, build_serve
    from repro.models import encode_params_for_pim, init_params
    from repro.models.lm import init_caches

    CASES = %r
    B, S, T, SEED = %r
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


    out = {}
    for name, (arch, kw, extra, meshes) in CASES.items():
        cfg = make_cfg(get_config, arch, kw, extra)
        p0 = init_params(jax.random.PRNGKey(SEED), cfg)
        if cfg.pim.enabled and cfg.pim.precoded:
            p0 = encode_params_for_pim(p0, cfg)
        for path, a in flat(p0).items():
            out[f"{name}/p0/{path}"] = a
        batch = {"tokens": jnp.asarray(inp[f"{name}/tokens"], jnp.int32)}
        if f"{name}/aux" in inp:
            batch["aux"] = jnp.asarray(inp[f"{name}/aux"])
        pshape = ShapeSpec("custom", S, B, "prefill")
        dshape = ShapeSpec("custom", S + T, B, "decode")
        full = init_caches(cfg, B, S + T)
        for ms in meshes:
            tag = f"{name}/{ms[0]}x{ms[1]}"
            mesh = compat_make_mesh(ms, ("data", "model"))
            rules = rules_for_cell(mesh, cfg, pshape,
                                   settings_for(arch, pshape))
            step, _, shardings = build_prefill(cfg, pshape)
            in_sh, out_sh = shardings(mesh, rules)
            with use_rules(mesh, rules):
                params = jax.device_put(p0, in_sh[0])
                logits, caches = jax.jit(step, in_shardings=in_sh,
                                         out_shardings=out_sh)(params, batch)
            out[f"{tag}/prefill_logits"] = np.asarray(logits)
            for path, a in flat(caches).items():
                out[f"{tag}/prefill_caches/{path}"] = a
            # the prompt's caches in S + T deep buffers (rings stay W long)
            caches = jax.tree.map(
                lambda c, f: jnp.pad(c, [(0, 0), (0, 0),
                                         (0, f.shape[2] - c.shape[2])]
                                     + [(0, 0)] * (c.ndim - 3)),
                caches, full)
            rules = rules_for_cell(mesh, cfg, dshape,
                                   settings_for(arch, dshape))
            step, _, shardings = build_serve(cfg, dshape)
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
                    if "aux" in batch:
                        b["aux"] = batch["aux"]
                    logits, caches = serve(params, caches, b)
                    out[f"{tag}/decode_logits{i}"] = np.asarray(logits)
            for path, a in flat(caches).items():
                out[f"{tag}/decode_caches/{path}"] = a
    np.savez(sys.argv[2], **out)
    print("JAX-TP-SERVE-OK")
""") % (CASES, (B, S, T, SEED),
        textwrap.indent(inspect.getsource(make_cfg), "    ").lstrip())


@pytest.fixture(scope="module")
def jax_serve(tmp_path_factory):
    """The JAX side, from one subprocess with eight host devices."""
    d = tmp_path_factory.mktemp("tp_serve")
    np.savez(d / "in.npz", **{f"{name}/{k}": v for name in CASES
                              for k, v in _inputs(name).items()})
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
    assert proc.returncode == 0 and "JAX-TP-SERVE-OK" in proc.stdout, \
        proc.stderr
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


def _np(t):
    if hasattr(t, "sharding"):
        t = t.gather(CPU)
    return t.detach().float().cpu().numpy()


def _placed(out, name, mesh, rules):
    cfg = _cfg(name)
    (p_sh, _), _ = build_prefill(cfg)[1](mesh, rules)
    return params_from_arrays(_tree(out, f"{name}/p0/"), cfg,
                              shardings=p_sh)


def _ulp(arr) -> float:
    """One bf16 ulp at the largest magnitude of `arr`."""
    top = float(np.abs(arr).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top else 0.0


def _check_caches(got, want, tag, cfg, rows=None):
    """Each entry within one bf16 ulp of its largest magnitude (RoPE
    rotates K in float32, so an ulp of a large input lands on a small
    output); with PIM, its largest gap within 2^-3 of that magnitude and
    its median within the ulp. `rows`: the batch rows held (all)."""
    for pos, e in want.items():
        for nm, arr in e.items():
            got_ = _np(got[pos][nm])
            if rows is not None:
                got_, arr = got_[:, rows], arr[:, rows]
            if cfg.pim.enabled:
                d = np.abs(got_ - arr)
                assert d.max() <= PIM_ATOL * np.abs(arr).max() and \
                    np.median(d) <= _ulp(arr), (tag, pos, nm, d.max())
                continue
            np.testing.assert_allclose(got_, arr, rtol=0, atol=_ulp(arr),
                                       err_msg=f"{tag} {pos}/{nm}")


def _check_tokens(got, want, atol):
    """Greedy tokens equal where the JAX logits' top-2 margin is above
    2 atol (a closer pair may swap within the tolerance), and some are."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * atol
    assert sure.any()
    assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def _route_margins(monkeypatch):
    """Each `topk_route` call's data shard (0 outside a mesh step's
    threads) and K-th minus (K+1)-th router logit, in bf16 ulps of the
    row's largest (tests/test_torch_archs.py's record)."""
    from repro_torch.distributed.sharding import data_shard
    from repro_torch.nn import moe
    margins = []
    route = moe.topk_route

    def recording(logits, k):
        top = torch.sort(logits, dim=-1, descending=True)[0]
        ulp = torch.finfo(torch.bfloat16).eps * logits.abs().amax(-1)
        shard = data_shard()
        margins.append((0 if shard is None else shard[1], (
            (top[:, k - 1] - top[:, k]) / ulp.clamp_min(
                torch.finfo(torch.bfloat16).tiny)).numpy()))
        return route(logits, k)
    monkeypatch.setattr(moe, "topk_route", recording)
    return margins


def _tied_rows(margins, data: int, rows: int) -> np.ndarray:
    """(rows,) bool: a row with a near-tie among `margins`, the calls of
    one step: each data shard's (its rows' tokens), each layer's once a
    model position."""
    out = []
    for k in range(data):
        calls = [m for shard, m in margins if shard == k]
        tied = np.stack([m < NEAR_TIE_ULPS for m in calls]).any(0)
        out.append(tied.reshape(rows // data, -1).any(-1))
    return np.concatenate(out)


def _check_logits(got, want, cfg, msg, tied=None, off=None):
    """Logits against the JAX ones (B, S, V). `tied` (B,) marks the rows
    a router near-tie has touched: such a row may differ (at most one,
    tests/test_torch_archs.py's rule), and `off` (B,), updated in place,
    collects the rows that did; every other row is held."""
    if cfg.pim.enabled:
        d = np.abs(got - want)
        assert d.max() <= PIM_ATOL and np.median(d) <= PIM_MEDIAN, \
            (msg, d.max(), np.median(d))
        return
    if off is not None:
        now = np.abs(got - want).reshape(len(got), -1).max(-1) > LOGITS_ATOL
        assert not (now & ~tied).any(), (msg, np.flatnonzero(now))
        off |= now
        assert off.sum() <= 1, (msg, np.flatnonzero(off))
        got, want = got[~off], want[~off]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# (i) the serving cells' rules and the tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_rules_match_jax(arch, shape):
    """`settings_for` and `rules_for_cell` of every shape (the serving
    ones too) against the JAX functions on a stand-in mesh of the same
    axes; `fsdp_serve_for` gives a reduced copy its model's
    `fsdp_serve`."""
    assert list(ARCH_IDS) == list(JARCH_IDS)
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh = _mesh(*shape)
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": shape[0],
                                         "model": shape[1]})
    assert set(SHAPES) == set(JSHAPES)
    for name, s in SHAPES.items():
        st, jst = settings_for(arch, s), jcells.settings_for(arch, JSHAPES[
            name])
        assert dataclasses.asdict(st) == {
            k: v for k, v in dataclasses.asdict(jst).items()
            if k in dataclasses.asdict(st)}
        assert st.fsdp_serve == jst.fsdp_serve == fsdp_serve_for(
            cfg.reduced()), name
        rules = rules_for_cell(mesh, cfg, s, st)
        assert rules == jcells.rules_for_cell(jmesh, jcfg, JSHAPES[name],
                                              jst), name


@pytest.mark.parametrize("arch", [*ARCH_IDS, "paper_pim"])
def test_cache_and_pim_axes_match_jax(arch):
    """`cache_axes` as the JAX tree; `pim_param_axes` of a precoded
    config adds the JAX precoded leaves' axes to `param_axes`."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cache_axes(cfg) == {p: {k: tuple(v) for k, v in e.items()}
                               for p, e in jcache_axes(jcfg).items()}
    cfg = dataclasses.replace(cfg, pim=dataclasses.replace(
        cfg.pim, enabled=True, precoded=True))
    jcfg = dataclasses.replace(jcfg, pim=dataclasses.replace(
        jcfg.pim, enabled=True, precoded=True))
    want = jpim_param_axes(jparam_axes(jcfg), jcfg)
    got = pim_param_axes(param_axes(cfg), cfg)
    for path, ax in got.items():
        node = want
        for key in path.split("/"):
            node = node[key]
        assert tuple(node) == ax, path
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k for key, v in tree.items()
                    for k in leaves(v, f"{prefix}/{key}" if prefix else key)}
        return {prefix}
    assert set(got) == leaves(want)
    assert all(p.endswith(("_enc", "_alpha"))
               for p in set(got) - set(param_axes(cfg)))


def test_long_context_rules_and_item_14():
    """`long_500k`: on (1, 4) the KV sequence goes over `data` and
    `model` (2 KV heads do not divide 4) and a decode runs with it; on
    (2, 2) the KV heads divide `model` and the sequence splits over
    `data` alone (context parallelism: the batch whole on each data
    shard), and the prefill and decode run too; both against the
    unsharded prefill and decode."""
    cfg = _cfg("dense")
    long = SHAPES["long_500k"]
    model = init_params(cfg, SEED, device="cpu")
    inp = _inputs("dense")
    want = []
    pf, sh = build_prefill(cfg)
    lg, pre = pf(model, {"tokens": inp["tokens"][:1]})
    from repro_torch.models import init_caches
    caches = init_caches(cfg, 1, S + T, device="cpu")
    for pos, e in pre.items():
        for nm, val in e.items():
            caches[pos][nm][:, :, :val.shape[2]] = val
    sv, _ = build_serve(cfg, 1, S + T)
    for i in range(T):
        want.append(sv(model, caches, {"tokens": inp["toks"][i][:1],
                                       "pos": S + i})[0])
    for shape, kv_seq in (((1, 4), ("data", "model")), ((2, 2), ("data",))):
        mesh = _mesh(*shape)
        rules = rules_for_cell(mesh, cfg, long,
                               settings_for("granite_3_2b", long))
        assert rules["batch"] is None and rules["kv_seq"] == kv_seq
        (p_sh, _), _ = sh(mesh, rules)
        placed = place_params(model, p_sh)
        tpf, _ = build_prefill(cfg, mesh=mesh, rules=rules)
        tlg, tc = tpf(placed, {"tokens": inp["tokens"][:1]}, max_seq=S + T)
        assert model_dim(tc["pos0"]["k"].sharding, 5) == (
            2 if "model" in kv_seq else 3)
        assert tc["pos0"]["k"].sharding.parts(5)[2] == 4 // shape[1] * (
            shape[1] if "model" in kv_seq else 1)
        torch.testing.assert_close(tlg, lg, rtol=0, atol=LOGITS_ATOL)
        tsv, _ = build_serve(cfg, 1, S + T, mesh=mesh, rules=rules)
        got = []
        for i in range(T):
            got.append(tsv(placed, tc, {"tokens": inp["toks"][i][:1],
                                        "pos": S + i})[0])
        torch.testing.assert_close(torch.cat(got, 1), torch.cat(want, 1),
                                   rtol=0, atol=LOGITS_ATOL)


# ---------------------------------------------------------------------------
# (ii) the row-parallel protected matmul, bit for bit
# ---------------------------------------------------------------------------


PIM_SPEC = dataclasses.replace(get_config("paper_pim").pim,
                               code_name="wl40_r08")
MATMUL_CASES = {
    "clean": (PIM_SPEC, 256, None, False, True),
    "per_call_encode": (PIM_SPEC, 256, None, False, False),
    "faults": (PIM_SPEC, 256, (5e-3, 1e-3), False, True),
    "out_noise": (PIM_SPEC, 256, None, True, True),
    # 64 rows a position, groups of 48 rows: groups 1 and 3 straddle
    "adc_straddle": (dataclasses.replace(PIM_SPEC, adc_levels=15,
                                         row_parallelism=48), 256,
                     (5e-3, 0.0), False, True),
    # one group over every position
    "adc_one_group": (dataclasses.replace(PIM_SPEC, adc_levels=41,
                                          row_parallelism=0), 256, None,
                      False, True),
    # 60 rows a position, groups of 100 rows over up to three positions
    "adc_wide_groups": (dataclasses.replace(PIM_SPEC, adc_levels=31,
                                            row_parallelism=100), 240,
                        None, False, True),
    "budget": (dataclasses.replace(PIM_SPEC, mode="correct_budget",
                                   correct_budget=5), 256, (5e-3, 0.0),
               False, True),
    "detect": (dataclasses.replace(PIM_SPEC, mode="detect"), 256,
               (5e-3, 0.0), False, True),
    "off": (dataclasses.replace(PIM_SPEC, mode="off"), 256, (5e-3, 0.0),
            False, True),
}


@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_row_parallel_protected_matmul_is_exact(case):
    """`PIMContext.matmul` over `Parts` (x split by its last dimension,
    the weight by rows over 4 positions) equals the unsharded call on
    the same x bit for bit, whole at every position, with the same
    `stats()`; every position's launches are tagged with its position."""
    spec, K, faults, noisy, precoded = MATMUL_CASES[case]
    g = torch.Generator().manual_seed(0)
    W = 0.02 * torch.randn(K, 96, generator=g)
    x = torch.randn(6, 3, K, generator=g).to(torch.bfloat16)
    enc, alpha = PIMContext(spec).encode_weight(W)
    noise = None
    if noisy:
        noise = (torch.rand((18, enc.shape[1]), generator=g) < 0.01).to(
            torch.int32)

    def ctx():
        c = PIMContext(spec)
        return c.with_faults(7, *faults) if faults else c
    ref, tp = ctx(), ctx()
    kw = dict(enc=enc, alpha=alpha) if precoded else {}
    want = ref.matmul(x, W, "attn_o", out_noise=noise, **kw)
    M = 4
    pos = [(0, j) for j in range(M)]

    def parts(ts, layout):
        return Parts(ts, layout, positions=pos, rules={})
    kw = dict(enc=parts(list(enc.chunk(M, 0)), 0),
              alpha=parts([alpha] * M, "whole")) if precoded else {}
    with build.by_position() as log:
        got = tp.matmul(parts(list(x.chunk(M, -1)), 2),
                        parts(list(W.chunk(M, 0)), 0), "attn_o",
                        out_noise=noise, **kw)
    assert got.layout == "whole"
    for t in got:
        assert torch.equal(t, want), case
    assert tp.stats() == ref.stats()
    if (faults or noisy) and spec.mode != "off":
        assert ref.stats()["detected_words"] > 0
    assert set(log.launches) <= set(pos)


# ---------------------------------------------------------------------------
# (iii) prefill and decode against the JAX steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,shape", RUNS)
def test_tp_serving_matches_jax(jax_serve, name, shape, monkeypatch):
    """The port's `build_prefill` and `build_serve` steps over a (data,
    model) mesh against the JAX steps on the same mesh and rules: the
    prefill's logits and caches, then four decode steps from the JAX
    prefill's caches (logits, greedy tokens, the caches after them);
    each position holding 1/M of every leaf the rules split over
    `model`, the precoded ones too."""
    out = jax_serve
    cfg, mesh = _cfg(name), _mesh(*shape)
    tag = f"{name}/{shape[0]}x{shape[1]}"
    inp = _inputs(name)
    prules, drules = _rules(name, mesh, PREFILL), _rules(name, mesh, DECODE)
    model = _placed(out, name, mesh, prules)
    M = shape[1]
    leaves = {**model.placed, **model.buffers}
    if cfg.pim.enabled:
        assert {n.rsplit(".", 1)[1] for n in model.buffers} == {
            "wo_enc", "wo_alpha", "w_down_enc", "w_down_alpha"}
    for nm, p in leaves.items():
        if model_dim(p.sharding, p.ndim) is not None:
            for t in p.distinct():
                assert t.numel() * M * (p.sharding.parts(p.ndim)[
                    0] if p.ndim else 1) >= int(np.prod(p.shape)) / (
                    shape[0] if "data" in str(p.sharding.spec) else 1), nm
            held = {p.sharding.index(pos, p.ndim): t.numel()
                    for pos, t in p.positions() if pos[1] == 0}
            assert sum(held.values()) * M == int(np.prod(p.shape)), nm
    batch = {k: inp[k] for k in ("tokens", "aux") if k in inp}
    pf, _ = build_prefill(cfg, mesh=mesh, rules=prules)
    margins = _route_margins(monkeypatch) if cfg.n_experts else []
    tied = np.zeros(B, dtype=bool)       # rows a router near-tie touched
    off = np.zeros(B, dtype=bool) if margins else None
    logits, caches = pf(model, batch)
    if margins:
        tied |= _tied_rows(margins, shape[0], B)
        margins.clear()
    _check_logits(_np(logits), out[f"{tag}/prefill_logits"], cfg, tag,
                  tied, off)
    held = None if off is None else ~off
    _check_caches(caches, _tree(out, f"{tag}/prefill_caches/"), tag, cfg,
                  held)

    full = _tree(out, f"{tag}/prefill_caches/")
    from repro_torch.models import init_caches
    want_shapes = init_caches(cfg, B, S + T, device="meta")
    padded = {pos: {nm: np.pad(a, [(0, 0), (0, 0), (0, want_shapes[pos][
        nm].shape[2] - a.shape[2])] + [(0, 0)] * (a.ndim - 3))
        for nm, a in e.items()} for pos, e in full.items()}
    caches = caches_from_arrays(cfg, padded, mesh=mesh, rules=drules)
    sv, _ = build_serve(cfg, B, S + T, mesh=mesh, rules=drules)
    got, want = [], []
    for i in range(T):
        b = {"tokens": inp["toks"][i], "pos": S + i}
        if "aux" in inp:
            b["aux"] = inp["aux"]
        lg, caches = sv(model, caches, b)
        if margins:
            tied |= _tied_rows(margins, shape[0], B)
            margins.clear()
        got.append(_np(lg))
        want.append(out[f"{tag}/decode_logits{i}"])
        _check_logits(got[-1], want[-1], cfg, f"{tag} step {i}", tied, off)
    rows = slice(None) if off is None else ~off
    _check_tokens(np.concatenate([g[rows] for g in got]),
                  np.concatenate([w[rows] for w in want]),
                  PIM_ATOL if cfg.pim.enabled else LOGITS_ATOL)
    _check_caches(caches, _tree(out, f"{tag}/decode_caches/"), tag, cfg,
                  None if off is None else ~off)


# ---------------------------------------------------------------------------
# (iv) against the port's unsharded serving
# ---------------------------------------------------------------------------


def _unsharded(cfg, model, inp, pim_ctx=None):
    """The unsharded prefill and T decode steps (logits and caches)."""
    from repro_torch.models import init_caches
    pf, _ = build_prefill(cfg, pim_ctx=pim_ctx)
    batch = {k: inp[k] for k in ("tokens", "aux") if k in inp}
    lg, pre = pf(model, batch)
    caches = init_caches(cfg, B, S + T, device="cpu")
    for pos, e in pre.items():
        for nm, val in e.items():
            caches[pos][nm][:, :, :val.shape[2]] = val
    sv, _ = build_serve(cfg, B, S + T, pim_ctx=pim_ctx)
    steps = []
    for i in range(T):
        b = {"tokens": inp["toks"][i], "pos": S + i, **(
            {"aux": inp["aux"]} if "aux" in inp else {})}
        steps.append(sv(model, caches, b)[0])
    return lg, torch.cat(steps, 1), caches


def _sharded(cfg, model, inp, mesh, rules, pim_ctx=None):
    """The same on `mesh`: the prefill placed S + T deep, then T steps."""
    (p_sh, _), _ = build_prefill(cfg)[1](mesh, rules)
    placed = place_params(model, p_sh)
    pf, _ = build_prefill(cfg, mesh=mesh, rules=rules, pim_ctx=pim_ctx)
    batch = {k: inp[k] for k in ("tokens", "aux") if k in inp}
    with build.by_position() as log:
        lg, caches = pf(placed, batch, max_seq=S + T)
    sv, _ = build_serve(cfg, B, S + T, mesh=mesh, rules=rules,
                        pim_ctx=pim_ctx)
    steps = []
    for i in range(T):
        b = {"tokens": inp["toks"][i], "pos": S + i, **(
            {"aux": inp["aux"]} if "aux" in inp else {})}
        steps.append(sv(placed, caches, b)[0])
    return lg, torch.cat(steps, 1), caches, log


@pytest.mark.parametrize("name,shape", [("dense", (2, 1)), ("dense", (1, 1)),
                                        ("moe_drops", (2, 1)),
                                        ("moe_pim", (2, 1)),
                                        ("pim", (2, 1))])
def test_model_axis_of_one_is_the_unsharded_path(name, shape):
    """A `model` axis of 1: each data shard runs the unsharded prefill and
    decode (MoE at the whole batch's capacity; with PIM, the shards in
    lockstep threads), logits and caches bit for bit."""
    cfg = _cfg(name)
    model = init_params(cfg, SEED, device="cpu")
    if cfg.pim.enabled:
        encode_params_for_pim(model, cfg)
    inp = _inputs(name)
    lg, steps, caches = _unsharded(cfg, model, inp)
    mesh = _mesh(*shape)
    tlg, tsteps, tcaches, _ = _sharded(cfg, model, inp, mesh,
                                       _rules(name, mesh, DECODE))
    assert torch.equal(tlg, lg) and torch.equal(tsteps, steps)
    for pos, e in caches.items():
        for nm, t in e.items():
            assert torch.equal(tcaches[pos][nm].gather(CPU), t), (pos, nm)


def test_flash_prefill_and_ring_decode_match_unsharded():
    """gemma2's rings under `attn_impl="flash"` on (1, 4), the prefill
    placed 16 deep from the port's own caches: logits against the
    unsharded run, every position's flash calls with Hq/M query heads,
    the ring split over the sequence, one position writing each slot."""
    arch, kw, extra, _ = CASES["rings"]
    cfg = make_cfg(get_config, arch, kw, dict(extra, attn_impl="flash"))
    model = init_params(cfg, SEED, device="cpu")
    inp = _inputs("rings")
    lg, steps, caches = _unsharded(cfg, model, inp)
    mesh = _mesh(1, 4)
    rules = rules_for_cell(mesh, cfg, DECODE, settings_for(arch, DECODE))
    tlg, tsteps, tcaches, log = _sharded(cfg, model, inp, mesh, rules)
    torch.testing.assert_close(tlg, lg, rtol=0, atol=LOGITS_ATOL)
    torch.testing.assert_close(tsteps, steps, rtol=0, atol=LOGITS_ATOL)
    assert all({h[1] for h in log.heads[(0, j)]} == {1} for j in range(4))
    for pos, e in caches.items():
        for nm, t in e.items():
            p = tcaches[pos][nm]
            if nm in ("k", "v"):
                assert model_dim(p.sharding, p.ndim) == 2
            want = t.float().numpy()
            np.testing.assert_allclose(_np(p), want, rtol=0,
                                       atol=_ulp(want), err_msg=f"{pos}/{nm}")


def test_faulted_pim_serving_matches_unsharded():
    """paper_pim precoded on (1, 4) with PIM output errors and weight
    flips: logits and caches bit for bit against the unsharded model under
    the same faults, and the same counts of words checked, flagged and
    left uncorrected."""
    cfg = _cfg("pim")
    model = init_params(cfg, SEED, device="cpu")
    encode_params_for_pim(model, cfg)
    inp = _inputs("pim")
    ref = PIMContext(cfg.pim).with_faults(3, 2e-3, 1e-4)
    tp = PIMContext(cfg.pim).with_faults(3, 2e-3, 1e-4)
    lg, steps, caches = _unsharded(cfg, model, inp, ref)
    mesh = _mesh(1, 4)
    tlg, tsteps, tcaches, log = _sharded(cfg, model, inp, mesh,
                                         _rules("pim", mesh, DECODE), tp)
    assert torch.equal(tlg, lg) and torch.equal(tsteps, steps)
    for pos, e in caches.items():
        for nm, t in e.items():
            assert torch.equal(tcaches[pos][nm].gather(CPU), t), (pos, nm)
    assert tp.stats() == ref.stats()
    assert ref.stats()["detected_words"] > 0
