"""Port parity: the MoE FFN (`repro_torch.nn.moe`) against the JAX
package's `repro.nn.moe` and `repro.nn.moe_shard._local_moe`.

The cases of tests/test_moe.py run on the port, and the port is held
against the JAX functions on identical inputs: expert weights from the
JAX package's `init_moe`, tokens from numpy. Tolerances:

- routing (`topi`) and the dispatch (sort order, expert of each slot,
  its token, `keep`, its buffer row): exact, on identical float32
  logits, ties included (the lower expert id first, `jax.lax.top_k`'s
  rule; +0 above -0, the float total order); the gate weights: exact
  after the bf16 cast.
- the combine: bitwise equal to the JAX package's `.at[tok_of].add` on
  identical slot outputs and weights (each token's slots added one by
  one in bf16, in the sorted order).
- `shard_ep` runs `sorted_ep` (`_local_moe` at ep = 1): bitwise equal to
  it, and to the JAX `_local_moe` at ep = 1 within the outputs' atol.
- whole-layer outputs against the JAX layer: atol 2**-12 on outputs of
  |y| up to about 0.009, four bf16 ulps at that size (the largest gap
  measured is 6.1e-5, one ulp): the grouped products round in bf16 in
  another order than XLA's. The routing is equal on these inputs (the
  same zero rows at capacity; the decode case asserts equal top-k), so
  no output differs by an expert.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.nn import moe as jmoe
from repro.nn import moe_shard as jmoe_shard
from repro_torch.configs import get_config
from repro_torch.nn import moe
from _torch_threads import torch_threads_per_worker  # noqa: F401

OUT_ATOL = 2 ** -12
# compiled once a config: XLA runs the same programs as eagerly, faster
jdense = jax.jit(jmoe.moe_dense, static_argnums=2)
jsorted = jax.jit(jmoe.moe_sorted_ep, static_argnums=2)



def _cfgs(E=8, k=2, cf=8.0, name="olmoe_1b_7b"):
    j = dataclasses.replace(jget_config(name).reduced(n_experts=E),
                            top_k=k, capacity_factor=cf)
    t = dataclasses.replace(get_config(name).reduced(n_experts=E),
                            top_k=k, capacity_factor=cf)
    return j, t


def _layers(jcfg, cfg, seed=0, d_ff=32):
    """The JAX package's `init_moe` weights and the port's MoE holding
    the same values."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, d_ff)
    layer = moe.MoE(cfg, d_ff, device="cpu")
    with torch.no_grad():
        for name, param in layer.named_parameters():
            param.copy_(torch.tensor(np.asarray(jp[name])))
    return jp, layer


def _x(rng, T, d):
    x = rng.normal(size=(T, d)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _jax_plan(topi, E, K, cap):
    """The JAX package's sorted_ep dispatch (moe.py:64-75) on `topi`."""
    T = topi.shape[0]
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(T * K, dtype=jnp.int32) - starts[sorted_e]
    keep = pos_in_e < cap
    return order, sorted_e, order // K, keep, jnp.where(keep, pos_in_e, cap)


# ---------------------------------------------------------------------------
# tests/test_moe.py on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,k", [(4, 1), (8, 2), (8, 8)])
def test_sorted_ep_matches_dense_with_ample_capacity(rng, E, k):
    jcfg, cfg = _cfgs(E=E, k=k, cf=float(E))     # capacity >= all tokens
    jp, layer = _layers(jcfg, cfg)
    jx, x = _x(rng, 24, cfg.d_model)
    with torch.no_grad():
        y_d = moe.moe_dense(layer, x, cfg)
        y_s = moe.moe_sorted_ep(layer, x, cfg)
    np.testing.assert_allclose(_np(y_d), _np(y_s), rtol=0.1, atol=0.05)
    # and each against its JAX counterpart
    np.testing.assert_allclose(_np(y_d), _np(jdense(jp, jx, jcfg)),
                               rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(
        _np(y_s), _np(jsorted(jp, jx, jcfg)), rtol=0,
        atol=OUT_ATOL)


def test_capacity_dropping(rng):
    """With capacity factor << 1 some tokens must be dropped to zero, the
    same tokens as in the JAX package."""
    jcfg, cfg = _cfgs(E=4, k=1, cf=0.3)
    jp, layer = _layers(jcfg, cfg)
    jx, x = _x(rng, 64, cfg.d_model)
    with torch.no_grad():
        y = _np(moe.moe_sorted_ep(layer, x, cfg))
    zero_rows = np.abs(y).sum(-1) == 0
    assert zero_rows.sum() > 0
    jy = _np(jsorted(jp, jx, jcfg))
    assert np.array_equal(zero_rows, np.abs(jy).sum(-1) == 0)
    np.testing.assert_allclose(y, jy, rtol=0, atol=OUT_ATOL)


def test_routing_is_topk(rng):
    jcfg, cfg = _cfgs(E=8, k=2)
    _, layer = _layers(jcfg, cfg, seed=1)
    _, x = _x(rng, 16, cfg.d_model)
    with torch.no_grad():
        topi, w = moe.route(layer, x, cfg)
        logits = _np(moe.router_logits(layer, x))
    assert topi.shape == (16, 2)
    assert np.allclose(_np(w).sum(-1), 1.0, atol=2e-2)
    ref = np.argsort(-logits, axis=-1)[:, :2]
    assert (np.sort(topi.numpy(), -1) == np.sort(ref, -1)).all()


# ---------------------------------------------------------------------------
# exact routing, dispatch and combine against the JAX package
# ---------------------------------------------------------------------------


def test_routing_and_dispatch_exact_with_ties(rng):
    """Identical float32 logits with constructed ties: the same experts in
    the same order, the same gate weights, and the same sort, `keep` and
    buffer rows at a capacity that drops."""
    T, E, K = 64, 8, 2
    logits = np.round(rng.normal(size=(T, E)) * 2).astype(np.float32) / 2
    logits[0] = 1.0                              # all tied
    logits[1, [2, 5, 6]] = 3.0                   # three tied at the top
    logits[2, [0, 7]] = 9.0
    logits[3, [1, 4]] = [-0.0, 0.0]              # +0 above -0, as XLA
    assert sum(len(set(r)) < E for r in logits) > T // 2
    jv, ji = jax.lax.top_k(jnp.asarray(logits), K)
    jw = jax.nn.softmax(jv, axis=-1).astype(jnp.bfloat16)
    topi, w = moe.topk_route(torch.from_numpy(logits), K)
    assert np.array_equal(topi.numpy(), np.asarray(ji))
    assert topi[0].tolist() == [0, 1] and topi[1].tolist() == [2, 5]
    assert np.array_equal(_np(w), _np(jw))
    for cap in (1, 5, T * K):
        plan = moe.dispatch(topi, E, cap)
        want = _jax_plan(ji, E, K, cap)
        got = (plan.order, plan.sorted_e, plan.tok_of, plan.keep,
               plan.safe_pos)
        for name, a, b in zip(("order", "sorted_e", "tok_of", "keep",
                               "safe_pos"), got, want, strict=True):
            assert np.array_equal(a.numpy(), np.asarray(b)), (cap, name)


def test_combine_bitwise_equals_jax_scatter_add(rng):
    """The combine on identical bf16 slot outputs and gate weights: equal
    to `jnp.zeros(...).at[tok_of].add(w_slots * y_slots)` bit for bit."""
    T, E, K, d = 48, 8, 4, 64
    logits = rng.normal(size=(T, E)).astype(np.float32)
    topi, w = moe.topk_route(torch.from_numpy(logits), K)
    plan = moe.dispatch(topi, E, cap=20)          # some slots dropped
    assert not bool(plan.keep.all())
    y_slots = torch.from_numpy(
        rng.normal(size=(T * K, d)).astype(np.float32)).to(torch.bfloat16)
    y_slots = torch.where(plan.keep[:, None], y_slots,
                          torch.zeros((), dtype=torch.bfloat16))
    got = moe.combine(w, y_slots, plan, T)
    jw = jnp.asarray(_np(w)).astype(jnp.bfloat16)
    jy = jnp.asarray(_np(y_slots)).astype(jnp.bfloat16)
    w_slots = jw.reshape(-1)[jnp.asarray(plan.order.numpy())]
    want = jnp.zeros((T, d), jnp.bfloat16).at[
        jnp.asarray(plan.tok_of.numpy())].add(w_slots[:, None] * jy)
    assert np.array_equal(_np(got), _np(want))


def test_shard_ep_equals_sorted_ep(rng):
    """`moe_impl="shard_ep"` runs sorted_ep, which is `_local_moe` at ep =
    1: without a mesh the JAX package's shard_ep recurses (ROADMAP Queue
    3), so the port is held to sorted_ep's output bit for bit, and to the
    JAX `_local_moe` at ep = 1 (under `vmap` over a one-member "model"
    axis) within OUT_ATOL, at a capacity that drops."""
    jcfg, cfg = _cfgs(E=8, k=2, cf=0.5)
    jp, layer = _layers(jcfg, cfg)
    jx, x = _x(rng, 32, cfg.d_model)
    with torch.no_grad():
        y_s = moe.moe_sorted_ep(layer, x, cfg)
        y_l = moe.moe_apply(layer, x[None],
                            dataclasses.replace(cfg, moe_impl="shard_ep"))[0]
    assert torch.equal(y_s, y_l)
    local = jax.vmap(lambda *a: jmoe_shard._local_moe(*a, jcfg, 1),
                     axis_name="model")
    y_j = local(*(a[None] for a in (jx, jp["router"], jp["w_gate"],
                                    jp["w_up"], jp["w_down"])))[0]
    np.testing.assert_allclose(_np(y_l), _np(y_j), rtol=0, atol=OUT_ATOL)
    with pytest.raises(RecursionError):
        jmoe.moe_apply(jmoe.init_moe(jax.random.PRNGKey(0), jcfg, 32),
                       jnp.zeros((1, 2, cfg.d_model), jnp.bfloat16),
                       dataclasses.replace(jcfg, moe_impl="shard_ep"))


def test_decode_capacity_drop_reproduced(rng):
    """A decode step of 4 tokens through olmoe's routing (64 experts,
    top 8): capacity max(1, int(4·8/64·1.25)) = 1, so every second token
    on an expert is dropped, in the port as in the JAX package."""
    jcfg = dataclasses.replace(jget_config("olmoe_1b_7b").reduced(
        n_experts=64), top_k=8)
    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(
        n_experts=64), top_k=8)
    assert moe.capacity(4, cfg) == 1
    jp, layer = _layers(jcfg, cfg, d_ff=32)
    jx, x = _x(rng, 4, cfg.d_model)
    with torch.no_grad():
        topi, _ = moe.route(layer, x, cfg)
        plan = moe.dispatch(topi, 64, 1)
        y = moe.moe_sorted_ep(layer, x, cfg)
    jtopi, _ = jmoe._route(jp, jx, jcfg)
    assert np.array_equal(topi.numpy(), np.asarray(jtopi))
    dropped = int((~plan.keep).sum())
    assert dropped == 4 * 8 - len(set(topi.reshape(-1).tolist())) > 0
    np.testing.assert_allclose(_np(y), _np(jsorted(jp, jx, jcfg)),
                               rtol=0, atol=OUT_ATOL)
