"""Port parity: every architecture of `configs.ARCH_IDS` and `paper_pim`
on the CPU against the JAX package (tests/test_archs_smoke.py mirrored).

Each architecture at its `.reduced()` size (d_model 64, one group, vocab
512; MoE configs 8 experts, cross and encoder inputs of 16 aux tokens).
The weights are the port's seeded `init_params` laid out as the JAX
pytree (its structure and shapes checked against the JAX `init_params`
by `jax.eval_shape`: the JAX package's own init of jamba takes seconds)
and carried across by `convert.params_from_arrays`; tokens, aux
embeddings and optimizer states are drawn with numpy from a seed. The
JAX loss, logits and gradients come from one compiled `value_and_grad`
an architecture (remat off on the JAX side: recomputation changes no
value). Tolerances:

- `forward` logits against the JAX forward: atol 2**-6, two bf16 ulps
  at |logit| in [1, 2) (logits up to about 1.4; the largest gap measured
  is 0.006, jamba): both packages compute in bf16, but XLA's CPU build
  and PyTorch round the bf16 products, the SiLU/GELU and the MoE's
  grouped products at slightly different places. In the MoE configs a
  token whose K-th and (K+1)-th router logits are within 4 bf16 ulps
  (at the row's largest logit) in some layer may pick another expert in
  XLA: its row may differ (at most 1 in 16, each such row a near tie),
  at a capacity that holds every slot (`_forward_cfgs`); exact routing
  and drops on identical inputs are held in tests/test_torch_moe.py.
- the loss: rtol 1e-4; every gradient within 5e-2 of its leaf's largest
  |gradient| (the bf16 roundings carried through the backward pass; the
  largest gap measured is 2.2%, gemma2's `wq`). MoE configs route to
  every expert here (`_train_cfgs`); at their own expert count, top-k
  and capacity (slots dropped), with the port's routing given to the
  JAX `_route`, in `test_moe_gradients_match_jax_at_real_top_k`.
- one train step (`launch.steps.build_train`, 2 microbatches, the
  architecture's optimizer: AdamW or Adafactor) from identical nonzero
  optimizer states (second moments in [1e-3, 2e-3), away from the
  division's steep end), against the JAX optimizer's update of the JAX
  gradients: each parameter's change within 0.1 of its leaf's largest
  change, plus one float32 ulp of the leaf (the gradients' bf16 noise,
  up to 5e-2 of a leaf's largest gradient, moves an update by up to
  twice as much where its second moment is small; a leaf whose update is
  below a float32 ulp, such as jamba's mamba `D`, differs by that ulp).
- prefill/decode consistency: the JAX test's tolerances (1e-3, or 0.05
  with mamba layers; MoE configs under `moe_impl="dense"`, as there).
- `encode_params_for_pim` on reduced jamba and arctic: every precoded
  int8 leaf exactly, the ternary scales to rtol 2**-20 (a float32 mean
  summed in another order, as in tests/test_torch_pim_serving.py).
- remat "dots" against "full": gradients bitwise equal (the same
  operations, saved or recomputed); "dots"' backward pass runs no more
  `aten.mm` than a pass without remat, "full"'s more.
- `quantize_ef`/`dequantize`: payload, scale and residual exact against
  the JAX functions.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import optim as joptim
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.distributed import compression as jcomp
from repro.models import encode_params_for_pim as jencode_params_for_pim
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.nn import moe as jmoe
from repro_torch import optim
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import opt_state_from_arrays, params_from_arrays
from repro_torch.distributed import compression
from repro_torch.launch.cells import optimizer_for
from repro_torch.launch.steps import build_train
from repro_torch.models import (decode_step, encode_params_for_pim, forward,
                                init_params, loss_fn, prefill)
from repro_torch.nn import moe
from _torch_threads import torch_threads_per_worker  # noqa: F401

ALL = ARCH_IDS + ["paper_pim"]
LOGITS_ATOL = 2 ** -6
GRAD_TOL = 5e-2
LR = 0.1            # 2e-3 at step 4 of the warmup: updates far above
                    # a float32 ulp of the parameters
UPDATE_TOL = 0.1
B, S = 2, 16


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _node(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def _stacked(path, tensors):
    arrs = [t.detach().numpy() for t in tensors]
    return np.stack(arrs) if path.startswith(("groups/", "encoder/")) \
        else arrs[0]


def _jax_tree(model):
    """The port's parameters as the JAX package's pytree of numpy arrays
    (group and encoder leaves stacked over layers)."""
    tree = {}
    for path, ps in model.leaves().items():
        *keys, leaf = path.split("/")
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = _stacked(path, ps)
    return tree


@functools.lru_cache(maxsize=None)
def _setup(arch, **over):
    """(JAX cfg, JAX params, port cfg, batch) of the reduced architecture
    (`over` passed to `.reduced`). The weights are the port's
    `init_params` (seeded; the JAX package's distributions) in the JAX
    pytree, whose structure and shapes are checked against
    `jax.eval_shape` of the JAX `init_params`."""
    jcfg = jget_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = _jax_tree(init_params(cfg, 0, device="cpu"))
    want = jax.eval_shape(lambda k: jinit_params(k, jcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(want) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(
        lambda w, a: w.shape == a.shape and a.dtype == np.float32, want,
        tree)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    batch["labels"] = batch["tokens"]
    if cfg.aux_kind:
        batch["aux"] = (0.1 * rng.normal(
            size=(B, cfg.n_aux_tokens, cfg.d_model))).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, batch


def _model(arch, **over):
    """A fresh port model holding the weights of `_setup`, carried across
    by `convert.params_from_arrays`."""
    jcfg, jparams, cfg, batch = _setup(arch, **over)
    return params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")


def _train_cfgs(arch):
    """The (JAX, port) configs of the gradient and train-step checks: MoE
    configs that route to fewer than all experts route to every one of
    them (top_k = n_experts). A token whose K-th and (K+1)-th router
    logits are a rounding apart may pick another expert in XLA, which
    sends its gradient to another expert's weights; with every expert
    routed there is no such choice, and the rest of the path (the
    dispatch, the grouped products, the combine) is the same. Mamba
    configs scan in chunks of 4 (four chunks of the 16 tokens, so the
    gradient crosses the chunks' carry; and jamba's XLA program compiles
    in two thirds of the time)."""
    jcfg, _, cfg, _ = _setup(arch)
    kw = {}
    if 0 < cfg.top_k < cfg.n_experts:
        kw["top_k"] = cfg.n_experts
    if any(s.kind == "mamba" for s in cfg.group_spec):
        kw["mamba_chunk"] = 4
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _loss_and_logits(p, jcfg, b):
    logits = jforward(p, jcfg, b["tokens"], aux=b.get("aux"))
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, b["labels"][..., None], -1)
    return nll.mean(), logits


_jgrad = jax.jit(jax.value_and_grad(_loss_and_logits, has_aux=True),
                 static_argnums=1)
_jforward = jax.jit(jforward, static_argnums=1)
_jencode = jax.jit(jencode_params_for_pim, static_argnums=1)
# the JAX optimizers' updates under build_train's schedule, compiled
_SCHEDULE = joptim.warmup_cosine(LR, 200, 10000)
_jupdate = {"adamw": jax.jit(joptim.adamw(_SCHEDULE).update),
            "adafactor": jax.jit(joptim.adafactor(_SCHEDULE).update)}



@functools.lru_cache(maxsize=None)
def _jax_pass(arch):
    """The JAX loss, gradients and logits of the batch under the train
    configs, one compile."""
    _, jparams, _, batch = _setup(arch)
    jcfg = dataclasses.replace(_train_cfgs(arch)[0], remat=False)
    (loss, logits), grads = _jgrad(jparams, jcfg,
                                   jax.tree.map(jnp.asarray, batch))
    return float(loss), np.asarray(logits), jax.tree.map(np.asarray, grads)


def _forward_cfgs(arch):
    """The (JAX, port) configs of the logits check: MoE configs that route
    to fewer than all experts get a capacity that holds every slot. A near
    tie that sends one token to another expert in XLA also moves the
    capacity positions of the tokens after it on both experts, so at a
    capacity that drops, one flip can change other tokens' rows (the drops
    themselves are held exactly against the JAX package on identical
    inputs in tests/test_torch_moe.py)."""
    jcfg, _, cfg, _ = _setup(arch)
    if 0 < cfg.top_k < cfg.n_experts:
        cf = cfg.n_experts / cfg.top_k
        return (dataclasses.replace(jcfg, capacity_factor=cf),
                dataclasses.replace(cfg, capacity_factor=cf))
    return jcfg, cfg


def _jax_logits(arch):
    """The JAX forward's logits under the logits check's config."""
    _, jparams, _, batch = _setup(arch)
    jcfg, cfg = _forward_cfgs(arch)
    if _train_cfgs(arch)[1] == cfg:
        return _jax_pass(arch)[1]
    return np.asarray(_jforward(jparams, jcfg, batch["tokens"],
                                aux=batch.get("aux")))


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _route_margins(monkeypatch):
    """Record, for each token, the smallest gap between its K-th and
    (K+1)-th router logit over every MoE layer of a pass, in units of
    the bf16 ulp at the row's largest |logit| (the scale of the bf16
    product's rounding)."""
    margins = []
    route = moe.topk_route

    def recording(logits, k):
        if k < logits.shape[1]:
            top = torch.sort(logits, dim=-1, descending=True)[0]
            ulp = torch.finfo(torch.bfloat16).eps * logits.abs().amax(-1)
            margins.append((top[:, k - 1] - top[:, k]) / ulp.clamp_min(
                torch.finfo(torch.bfloat16).tiny))
        return route(logits, k)

    monkeypatch.setattr(moe, "topk_route", recording)
    return margins


@pytest.mark.parametrize("arch", ALL)
def test_forward_matches_jax(arch, monkeypatch):
    """Logits against the JAX forward. In the MoE configs a token whose
    K-th and (K+1)-th router logits lie within 4 bf16 ulps (at the row's
    largest logit) in some layer
    may route to another expert in XLA (the router logits are bf16
    products of inputs a few ulps apart): such a row may differ, at most
    one row in 16; every other row is held to the tolerance."""
    _, _, _, batch = _setup(arch)
    cfg = _forward_cfgs(arch)[1]
    model = _model(arch)
    margins = _route_margins(monkeypatch)
    with torch.no_grad():
        logits = forward(model, cfg, batch["tokens"], aux=batch.get("aux"))
    assert logits.shape == (B, S, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert bool(margins) == (0 < cfg.top_k < cfg.n_experts)
    jlogits = _jax_logits(arch)
    near_tie = np.zeros(B * S, dtype=bool)
    for m in margins:
        near_tie |= (m < 4).numpy()
    off = np.abs(logits.numpy() - jlogits).max(-1).reshape(-1) > LOGITS_ATOL
    assert not (off & ~near_tie).any(), np.flatnonzero(off)
    assert off.sum() <= B * S // 16
    rows = ~off.reshape(B, S)
    np.testing.assert_allclose(logits.numpy()[rows], jlogits[rows], rtol=0,
                               atol=LOGITS_ATOL)


def _opt_state(arch, jparams, rng):
    """A nonzero optimizer state of the architecture's optimizer."""
    if optimizer_for(get_config(arch)) == "adamw":
        return {"m": jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
                    np.float32) * 0.01, jparams),
                "v": jax.tree.map(lambda p: (1 + rng.random(p.shape)).astype(
                    np.float32) * 1e-3, jparams),
                "step": np.int32(3)}

    def st(p):
        def pos(shape):
            return (1 + rng.random(shape)).astype(np.float32) * 1e-3
        if p.ndim >= 2:
            return {"vr": pos(p.shape[:-1]), "vc": pos(p.shape[:-2]
                                                      + p.shape[-1:])}
        return {"v": pos(p.shape)}
    return {"f": jax.tree.map(st, jparams), "step": np.int32(3)}


@pytest.mark.parametrize("arch", ALL)
def test_train_step_matches_jax(arch):
    """Loss and gradients against the JAX ones, then one `build_train`
    step from a nonzero optimizer state against the JAX optimizer's step
    on the JAX gradients from the same state."""
    _, jparams, _, batch = _setup(arch)
    cfg = _train_cfgs(arch)[1]
    jloss, _, jgrads = _jax_pass(arch)
    model = _model(arch)
    loss = loss_fn(model, cfg, _tbatch(batch))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-4)
    for path, ps in model.leaves().items():
        want = _node(jgrads, path)
        got = _stacked(path, [p.grad for p in ps])
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_TOL,
                                   err_msg=path)

    np_params = jax.tree.map(np.asarray, jparams)
    state = _opt_state(arch, np_params, np.random.default_rng(1))
    step, tx = build_train(cfg, microbatches=2, lr=LR)
    want_p, _, _ = _jupdate[optimizer_for(cfg)](
        jax.tree.map(jnp.asarray, jgrads), jax.tree.map(jnp.asarray, state),
        jax.tree.map(jnp.asarray, np_params))
    model = _model(arch)
    tstate = opt_state_from_arrays(state, model, device="cpu")
    tstate, metrics = step(model, tstate, _tbatch(batch))
    assert tstate["step"] == 4
    assert np.isfinite(float(metrics["loss"])) and 0 < float(
        metrics["loss"]) < 20
    for path, ps in model.leaves().items():
        p0 = _node(np_params, path)
        want = _node(want_p, path) - p0
        # and one float32 ulp of the parameters, where a leaf's update is
        # below it (a tiny gradient, e.g. a cross layer's norm)
        atol = UPDATE_TOL * np.abs(want).max() + np.spacing(
            np.abs(p0).max())
        np.testing.assert_allclose(_stacked(path, ps) - p0, want, rtol=0,
                                   atol=atol, err_msg=path)


def _fixed_route(topis):
    """The JAX package's `_route` with the top-k indices given: each call,
    in the layers' order, takes the next of `topis` (the port's); its gate
    weights are the softmax of its own logits at those indices, as
    `jax.lax.top_k`'s values would give."""
    calls = iter(topis)

    def route(params, x2d, cfg):
        logits = (x2d @ params["router"].astype(jmoe.CDT)).astype(
            jnp.float32)
        topi = jnp.asarray(next(calls).numpy().astype(np.int32))
        w = jax.nn.softmax(jnp.take_along_axis(logits, topi, axis=-1),
                           axis=-1)
        return topi, w.astype(jmoe.CDT)
    return route, calls


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "jamba_v01_52b",
                                  "arctic_480b"])
def test_moe_gradients_match_jax_at_real_top_k(arch, monkeypatch):
    """The loss, the logits and every gradient against the JAX ones at the
    architecture's own expert count, top-k and capacity factor (olmoe 8
    of 64, jamba 2 of 16, arctic 2 of 128; d_model 64), where slots are
    dropped at capacity (asserted in every MoE layer's pass). Both sides
    route alike: each MoE layer's top-k indices in the port are given to
    the JAX `_route` (`_fixed_route`), so a router near-tie cannot send a
    token to another expert in XLA, and the partial top-k's gradient
    (through the gate weights) and the `keep` mask's are held to the
    tolerances of `test_train_step_matches_jax`; the logits to
    LOGITS_ATOL in every row."""
    over = {"n_experts": get_config(arch).n_experts}
    jcfg, jparams, cfg, batch = _setup(arch, **over)
    assert 0 < cfg.top_k < cfg.n_experts
    if any(s.kind == "mamba" for s in cfg.group_spec):
        jcfg = dataclasses.replace(jcfg, mamba_chunk=4)
        cfg = dataclasses.replace(cfg, mamba_chunk=4)
    topis, drops = [], []
    route, dispatch = moe.topk_route, moe.dispatch

    def recording_route(logits, k):
        topi, w = route(logits, k)
        topis.append(topi.clone())
        return topi, w

    def recording_dispatch(topi, n_experts, cap):
        plan = dispatch(topi, n_experts, cap)
        drops.append(int((~plan.keep).sum()))
        return plan

    monkeypatch.setattr(moe, "topk_route", recording_route)
    monkeypatch.setattr(moe, "dispatch", recording_dispatch)
    model = _model(arch, **over)
    loss = loss_fn(model, cfg, _tbatch(batch))
    n_moe = len(topis)
    assert n_moe == len(drops) > 0 and all(d > 0 for d in drops), drops
    loss.backward()                     # recomputes the routing (remat)
    with torch.no_grad():
        logits = forward(model, cfg, batch["tokens"], aux=batch.get("aux"))
    assert len(topis) % n_moe == 0 and all(
        torch.equal(t, topis[i % n_moe]) for i, t in enumerate(topis))

    fixed, calls = _fixed_route(topis[:n_moe])
    monkeypatch.setattr(jmoe, "_route", fixed)
    jgrad = jax.jit(jax.value_and_grad(_loss_and_logits, has_aux=True),
                    static_argnums=1)
    (jloss, jlogits), jgrads = jgrad(jparams,
                                     dataclasses.replace(jcfg, remat=False),
                                     jax.tree.map(jnp.asarray, batch))
    assert next(calls, None) is None        # one call a MoE layer
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=LOGITS_ATOL)
    for path, ps in model.leaves().items():
        want = _node(jgrads, path)
        got = _stacked(path, [p.grad for p in ps])
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ALL)
def test_prefill_decode_consistency(arch):
    """decode_step at position S-1 with prefilled caches reproduces the
    last prefill logit; MoE configs under the dense oracle (capacity
    drops depend on the token count, which differs between a prefill and
    a one-token decode by construction)."""
    jcfg, jparams, cfg, batch = _setup(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_impl="dense")
    model = init_params(cfg, 0, device="cpu")
    toks, aux = torch.from_numpy(batch["tokens"]), batch.get("aux")
    lgs, caches = prefill(model, cfg, toks, aux=aux)
    lg2, _ = decode_step(model, cfg, caches, toks[:, -1:], S - 1, aux=aux)
    diff = float((lgs[:, -1] - lg2[:, 0]).abs().max())
    tol = 0.05 if any(s.kind == "mamba" for s in cfg.group_spec) else 1e-3
    assert diff <= tol, diff


def test_moe_capacity_paths():
    cfg = get_config("olmoe_1b_7b").reduced()
    model = init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    with torch.no_grad():
        lg_ep = forward(model, cfg, tokens)
        lg_dense = forward(model, dataclasses.replace(cfg, moe_impl="dense"),
                           tokens)
        lg_shard = forward(model, dataclasses.replace(
            cfg, moe_impl="shard_ep"), tokens)
    # same routing; sorted_ep may drop at capacity: a small deviation
    corr = np.corrcoef(lg_ep.numpy().ravel(), lg_dense.numpy().ravel())[0, 1]
    assert corr > 0.98
    assert torch.equal(lg_ep, lg_shard)


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "arctic_480b"])
def test_encode_params_for_pim_leaves_match_jax(arch):
    """Mamba blocks (no attention) and MoE blocks with and without a dense
    MLP: every precoded leaf the JAX transform writes, and no other."""
    jcfg, jparams, cfg, _ = _setup(arch)
    want = jax.tree.map(np.asarray, _jencode(jparams, jcfg))
    model = encode_params_for_pim(_model(arch), cfg)
    got = model.pim_leaves()
    n_enc = 0
    for i in range(len(cfg.group_spec)):
        node = want["groups"][f"pos{i}"]
        for sub, w in (("mlp", "w_down"), ("attn", "wo")):
            for suffix in ("_enc", "_alpha"):
                key = f"groups/pos{i}/{sub}/{w}{suffix}"
                if f"{w}{suffix}" not in node.get(sub, {}):
                    assert key not in got, key
                    continue
                have = _stacked(key, got[key])
                want_leaf = node[sub][f"{w}{suffix}"]
                if suffix == "_enc":
                    assert have.dtype == np.int8, key
                    assert np.array_equal(have, want_leaf), key
                else:                  # a float32 mean in another order
                    np.testing.assert_allclose(have, want_leaf,
                                               rtol=2 ** -20, err_msg=key)
                n_enc += 1
    assert n_enc == len(got) > 0


class _CountMM(TorchDispatchMode):
    """Counts the `aten.mm` calls dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_remat_dots_gradients_equal_full():
    """remat_policy "dots" (the un-batched products saved, the rest
    recomputed) gives "full"'s gradients bit for bit, and its backward
    pass runs as many `aten.mm` as without remat (it recomputes no
    un-batched product), where "full"'s runs more; jamba covers the
    mamba, MoE and attention layers, whisper the encoder."""
    for arch in ("jamba_v01_52b", "whisper_small"):
        _, _, cfg, batch = _setup(arch)
        model = init_params(cfg, 0, device="cpu")
        grads, mms = [], {}
        for policy in (None, "full", "dots"):
            model.zero_grad()
            c = dataclasses.replace(cfg, remat=policy is not None,
                                    remat_policy=policy or "full")
            loss = loss_fn(model, c, _tbatch(batch))
            with _CountMM() as count:
                loss.backward()
            mms[policy] = count.n
            if policy is not None:
                grads.append([p.grad.clone() for p in model.parameters()])
        assert all(torch.equal(a, b) for a, b in zip(*grads, strict=True))
        assert 0 < mms["dots"] == mms[None] < mms["full"], (arch, mms)


def test_quantize_ef_matches_jax(rng):
    x = rng.normal(size=(64,)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    ef, jef = compression.init_ef({"x": tx})["x"], jcomp.init_ef(
        {"x": jx})["x"]
    acc = np.zeros(64)
    for _ in range(40):
        q, s, ef = compression.quantize_ef(tx, ef)
        jq, js, jef = jcomp.quantize_ef(jx, jef)
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        assert np.array_equal(ef.residual.numpy(), np.asarray(jef.residual))
        deq = compression.dequantize(q, s)
        assert np.array_equal(deq.numpy(), np.asarray(jcomp.dequantize(jq,
                                                                       js)))
        acc += deq.numpy()
    # error feedback: the time average converges to the true value
    np.testing.assert_allclose(acc / 40, x, atol=2e-2)


def test_every_architecture_is_ported():
    assert ARCH_IDS == JARCH_IDS
    for arch in ALL:
        cfg = get_config(arch).reduced()
        assert optimizer_for(cfg) in ("adamw", "adafactor")
    assert isinstance(optim.adamw(1e-3), optim.Transform)
