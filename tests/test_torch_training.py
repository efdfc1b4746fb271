"""Port parity: the training path on the CPU against the JAX package.

Weights come from the JAX package's `init_params`, carried across with
`convert.params_from_arrays`; tokens, labels, gradients and optimizer
states are drawn with numpy from a seed and fed to both packages.
Tolerances:

- `forward` logits: atol 2**-6, two bf16 ulps at |logit| in [1, 2) (the
  logits here reach about 1.6). Both packages compute in bf16 with fp32
  norms and softmax, but XLA's CPU build and PyTorch round the bf16
  matmuls and activations at slightly different places; one ulp (0.0078)
  is the largest gap measured.
- `loss_fn`: rtol 1e-4 (measured gaps up to 1.6e-5).
- every parameter gradient: within 3e-2 of the leaf's largest |gradient|
  (the same bf16 roundings, carried through the backward pass; the
  largest gap measured is 1.3%).
- optimizer steps (fp32 arithmetic on identical inputs): rtol 1e-6, and
  an atol of one fp32 ulp of the leaf's largest parameter (of the array
  itself for Adafactor's vr/vc/v) for the few values that come out of a
  cancellation near 0: the global grad norm (and Adafactor's row, column
  and RMS means) sum in another order than XLA's, so a clip factor or a
  mean may differ in its last bit, and that bit shows at the
  parameters' magnitude (p1 - p0 in the momentum, p - lr·u).
- the data pipeline, checkpoints and restarts: exact.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import LayerSpec as JLayerSpec
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.launch.cells import settings_for as jsettings_for
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.configs.base import LayerSpec
from repro_torch.convert import opt_state_from_arrays, params_from_arrays
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.distributed.fault import RestartManager, StragglerWatchdog
from repro_torch.launch import train
from repro_torch.launch.cells import optimizer_for
from repro_torch.models import forward, init_params, loss_fn
from _torch_threads import torch_threads_per_worker  # noqa: F401

REDUCED = dict(n_groups=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
LOGITS_ATOL = 2 ** -6


def _configs(name):
    """Reduced (JAX, port) configs; gemma2 gets a window of 16 so that it
    bites at 48 tokens (its 4096 would not), keeping its softcaps."""
    j = jget_config(name).reduced(**REDUCED)
    t = get_config(name).reduced(**REDUCED)
    if name == "gemma2_27b":
        j = dataclasses.replace(j, n_groups=1, group_spec=(
            JLayerSpec(kind="attn", local_window=16), JLayerSpec(kind="attn")))
        t = dataclasses.replace(t, n_groups=1, group_spec=(
            LayerSpec(kind="attn", local_window=16), LayerSpec(kind="attn")))
    return j, t


def _node(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def _stacked(path, tensors):
    arrs = [t.detach().numpy().copy() for t in tensors]
    return np.stack(arrs) if path.startswith("groups/") else arrs[0]


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("name", ["granite_3_2b", "gemma2_27b"])
def test_forward_loss_and_grads_match_jax(rng, name, impl):
    jcfg, cfg = _configs(name)
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    params = jinit_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_arrays(jax.tree.map(np.asarray, params), cfg,
                               device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    labels[0, :5] = -1                                   # ignored
    loss_j, grads_j = jax.value_and_grad(jloss_fn)(
        params, jcfg, {"tokens": jnp.asarray(toks),
                       "labels": jnp.asarray(labels)})
    loss = loss_fn(model, cfg, {"tokens": torch.tensor(toks),
                                "labels": torch.tensor(labels)})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-4)
    for path, ps in model.leaves().items():
        want = _node(grads_j, path)
        got = np.stack([p.grad.numpy() for p in ps]) \
            if path.startswith("groups/") else ps[0].grad.numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=3e-2,
                                   err_msg=path)
    with torch.no_grad():
        logits = forward(model, cfg, torch.tensor(toks))
    want = np.asarray(jforward(params, jcfg, jnp.asarray(toks)))
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=LOGITS_ATOL)


def test_flash_equals_naive_and_remat_changes_nothing(rng):
    """Flash against naive logits within 0.05 (the JAX package's own
    model-level bound); remat on ("full" and "dots") and off give the
    same loss and gradients exactly (recomputation repeats the same
    operations)."""
    _, cfg = _configs("gemma2_27b")
    model = init_params(cfg, 0, device="cpu")
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 64)))
    with torch.no_grad():
        l1 = forward(model, cfg, toks)
        l2 = forward(model, dataclasses.replace(cfg, attn_impl="flash"),
                     toks)
    assert float((l1 - l2).abs().max()) < 0.05
    batch = {"tokens": toks, "labels": toks}
    grads = []
    for remat in (True, False):
        model.zero_grad()
        c = dataclasses.replace(cfg, attn_impl="flash", remat=remat)
        loss_fn(model, c, batch).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads, strict=True))
    model.zero_grad()
    c = dataclasses.replace(cfg, attn_impl="flash", remat_policy="dots")
    loss_fn(model, c, batch).backward()
    assert all(torch.equal(a, p.grad)
               for a, p in zip(grads[0], model.parameters(), strict=True))


def _grads_and_state(rng, jparams, kind):
    grads = jax.tree.map(
        lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1,
        jparams)
    if kind == "adamw":
        state = {"m": jax.tree.map(
                     lambda p: rng.normal(size=p.shape).astype(np.float32)
                     * 0.01, jparams),
                 "v": jax.tree.map(
                     lambda p: rng.random(size=p.shape).astype(np.float32)
                     * 1e-3, jparams),
                 "step": np.int32(3)}
    else:
        def st(p):
            if p.ndim >= 2:
                return {"vr": rng.random(p.shape[:-1]).astype(np.float32)
                        * 1e-3,
                        "vc": rng.random(p.shape[:-2] + p.shape[-1:])
                        .astype(np.float32) * 1e-3}
            return {"v": rng.random(p.shape).astype(np.float32) * 1e-3}
        state = {"f": jax.tree.map(st, jparams), "step": np.int32(3),
                 "m": jax.tree.map(
                     lambda p: rng.normal(size=p.shape).astype(np.float32)
                     * 1e-3, jparams)}
    return grads, state


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_step_matches_jax(rng, kind):
    """One update from identical parameters, gradients and (nonzero)
    states: parameters, moments and the grad norm agree; a stacked group
    leaf of Adafactor keeps the JAX package's factored vr/vc."""
    jcfg, cfg = _configs("granite_3_2b")
    jparams = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(1),
                                                    jcfg))
    grads, state = _grads_and_state(rng, jparams, kind)
    make = {"adamw": lambda m: m.adamw(m.warmup_cosine(3e-3, 2, 10)),
            "adafactor": lambda m: m.adafactor(1e-2, momentum=0.5,
                                               weight_decay=0.01)}[kind]
    new_p, new_s, gn = make(joptim).update(
        jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, jparams))

    model = params_from_arrays(jparams, cfg, device="cpu")
    tstate = opt_state_from_arrays(state, model, device="cpu")
    tgrads = {k: [t.clone() for t in v] for k, v in opt_state_from_arrays(
        {"m": grads, "step": 0}, model, device="cpu")["m"].items()}
    leaves = model.leaves()
    _, tstate, tgn = make(optim).update(tgrads, tstate, leaves)
    assert tstate["step"] == 4
    np.testing.assert_allclose(float(tgn), float(gn), rtol=1e-6)

    def close(got, want, scale, err_msg):
        ulp = float(np.spacing(np.abs(scale).max().astype(np.float32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=ulp,
                                   err_msg=err_msg)

    for path, ps in leaves.items():
        p = _node(new_p, path)
        close(_stacked(path, ps), p, p, path)
        for key in ("m", "v"):
            if key in tstate:
                close(_stacked(path, tstate[key][path]),
                      _node(new_s[key], path), p, path)
        if kind == "adafactor":
            for key, arr in tstate["f"][path].items():
                want = _node(new_s["f"], path + "/" + key)
                close(arr.numpy(), want, want, path + "/" + key)
    if kind == "adafactor":            # a stacked (n_groups, d) norm scale
        f = tstate["f"]["groups/pos0/norm1/scale"]
        assert set(f) == {"vr", "vc"} and f["vr"].shape == (2,)


def test_schedules_and_clipping_match_jax():
    js, ts = joptim.warmup_cosine(1.0, 10, 100), optim.warmup_cosine(
        1.0, 10, 100)
    for step in (0, 1, 5, 10, 20, 55, 99, 100, 150):
        assert float(ts(step)) == float(js(step)), step
    assert float(ts(0)) == 0.0 and float(ts(10)) == pytest.approx(1.0)
    assert float(ts(100)) == pytest.approx(0.1, abs=1e-6)
    assert float(optim.constant_lr(0.5)(7)) == 0.5
    clipped, gn = optim.clip_grads({"a": [torch.full((4,), 100.0)]}, 1.0)
    assert float(gn) == pytest.approx(200.0)
    assert float(clipped["a"][0].norm()) == pytest.approx(1.0, rel=1e-5)
    with pytest.raises(KeyError):
        optim.make_optimizer("sgd", 1e-3)


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_optimizer_choice_matches_jax(arch):
    """`optimizer_for` keys on the config name, so a reduced copy keeps its
    model's optimizer; it agrees with the JAX `settings_for` for every
    architecture."""
    want = jsettings_for(arch, JSHAPES["train_4k"]).optimizer
    assert optimizer_for(get_config(arch)) == want
    assert optimizer_for(get_config(arch).reduced()) == want


def test_optimizers_converge_on_a_quadratic():
    """The JAX package's convergence check, on the port's optimizers."""
    target = torch.tensor([1.0, -2.0, 0.5])
    for tx, thresh in ((optim.adamw(5e-2), 0.05),
                       (optim.adafactor(5e-1), 0.05),
                       (optim.adafactor(3e-1, momentum=0.5), 0.25)):
        params = {"w": [torch.ones((6, 3), requires_grad=True)],
                  "b": [torch.zeros(3, requires_grad=True)]}

        def loss():
            return ((torch.ones(6) @ params["w"][0] + params["b"][0]
                     - target) ** 2).sum()
        state = tx.init(params)
        l0 = float(loss())
        for _ in range(150):
            for ts in params.values():
                ts[0].grad = None
            loss().backward()
            grads = {k: [ts[0].grad] for k, ts in params.items()}
            tx.update(grads, state, params)
        assert float(loss()) < thresh * l0


def test_token_pipeline_is_bit_exact_with_resume():
    c, jc = (DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3),
             JDataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3))
    p, jp = TokenPipeline(c), JTokenPipeline(jc)
    for _ in range(3):
        a, b = next(p), next(jp)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key])
    assert p.state() == jp.state() == {"step": 3, "seed": 3}
    q = TokenPipeline.restore(c, {"step": 1, "seed": 3}, shard_index=1,
                              num_shards=2)
    jq = JTokenPipeline.restore(jc, {"step": 1, "seed": 3}, shard_index=1,
                                num_shards=2)
    assert np.array_equal(next(q)["tokens"], next(jq)["tokens"])


def test_checkpoint_roundtrip_atomic_retention(tmp_path):
    d = str(tmp_path)
    tree = {"p": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": {"s": 3 * np.ones(2, np.int32)}, "l": [torch.ones(2)],
            "step": 4}
    for step in (10, 20, 30, 40):
        ckpt.save_checkpoint(d, step, tree, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000030", "step_00000040"]
    out, man = ckpt.restore_checkpoint(d, tree)
    assert man["step"] == 40 and ckpt.latest_step(d) == 40
    assert torch.equal(out["p"], tree["p"]) and isinstance(out["p"],
                                                           torch.Tensor)
    assert np.array_equal(out["n"]["s"], tree["n"]["s"])
    assert torch.equal(out["l"][0], tree["l"][0]) and int(out["step"]) == 4
    # the JAX package reads the port's checkpoint and the port the JAX one
    jout, _ = jckpt.restore_checkpoint(d, {"p": 0, "n": {"s": 0},
                                           "l": [0], "step": 0})
    assert np.array_equal(jout["p"], tree["p"].numpy())
    jd = str(tmp_path / "jax")
    jckpt.save_checkpoint(jd, 7, {"w": np.linspace(0, 1, 5, dtype=np.float32)})
    back, _ = ckpt.restore_checkpoint(jd, {"w": torch.zeros(5)})
    assert torch.equal(back["w"], torch.linspace(0, 1, 5))


def test_checkpoint_nb_ldpc_protection_corrects_bitflips(tmp_path):
    """The paper's memory mode protecting the port's own storage: flips
    injected through the channel API are corrected on restore, and the
    protected payload is the JAX package's format."""
    from repro_torch.memory import uniform_flip
    d = str(tmp_path)
    tree = {"w": torch.linspace(-1, 1, 32)}
    ckpt.save_checkpoint(d, 1, tree, protect=True, device="cpu")
    n = ckpt.inject_storage_faults(d, uniform_flip(3, 8e-3), key=0,
                                   device="cpu")
    assert n > 0                                     # fixed key: deterministic
    out, man = ckpt.restore_checkpoint(d, tree, device="cpu")
    assert torch.equal(out["w"], tree["w"])          # ECC fixed the flips
    assert man["correction_stats"]["corrected"] > 0
    jout, _ = jckpt.restore_checkpoint(d, {"w": 0})
    assert np.array_equal(jout["w"], tree["w"].numpy())


def test_protected_array_keeps_a_scalar_shape():
    """A 0-d leaf (the optimizer's step) reads back 0-d from a protected
    array, as in the JAX package (the port once returned shape (1,))."""
    from repro.memory import ProtectedMemoryArray as JArray
    from repro_torch.memory import ProtectedMemoryArray
    mem, jmem = ProtectedMemoryArray("wl40_r08", device="cpu"), \
        JArray("wl40_r08")
    for x in (np.int32(4), np.float32(-2.5), torch.tensor(7)):
        mem.write("s", x)
        jmem.write("s", np.asarray(x))
        got, want = mem.read("s"), jmem.read("s")
        assert got.shape == want.shape == () and got == want


def test_restart_manager_recovers_from_crash(tmp_path):
    d = str(tmp_path)
    mgr = RestartManager(d, save_every=1, max_restarts=2, device="cpu")
    calls = {"n": 0}

    def init_fn():
        return {"x": torch.zeros(3)}

    def loop(start, data_state):
        calls["n"] += 1
        state = {"x": torch.full((3,), float(start))}
        for step in range(start, 5):
            state = {"x": state["x"] + 1}
            mgr.maybe_save(step, state, data_state={"step": step,
                                                    "seed": 0})
            if calls["n"] == 1 and step == 3:
                raise RuntimeError("simulated node failure")
        return 5

    assert mgr.run(loop, init_fn) == 5
    assert calls["n"] == 2 and ckpt.latest_step(d) == 4
    state, step, data_state = mgr.restore_or_init(init_fn)
    assert step == 4 and data_state == {"step": 4, "seed": 0}
    assert torch.equal(state["x"], torch.full((3,), 5.0))


def test_straggler_watchdog_flags():
    import time
    dog = StragglerWatchdog(threshold=1.5)
    for i in range(3):
        dog.step_start()
        time.sleep(0.01)
        dog.step_end(i)
    dog.step_start()
    time.sleep(0.08)
    dog.step_end(3)
    assert len(dog.flagged) == 1 and dog.flagged[0][0] == 3


def test_training_learns(tmp_path):
    """`tests/test_system.py::test_training_learns` on the port, on the
    CPU: reduced granite-3-2b through `main` with the same flags."""
    losses = train.main([
        "--arch", "granite_3_2b", "--reduced", "--steps", "30",
        "--batch", "4", "--seq", "64", "--d-model", "128", "--n-groups", "2",
        "--lr", "5e-3", "--ckpt-dir", str(tmp_path / "run"),
        "--save-every", "100", "--log-every", "100"], device="cpu")
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_training_restores_and_continues(tmp_path):
    d = str(tmp_path / "run")
    args = ["--arch", "granite_3_2b", "--reduced", "--steps", "12",
            "--batch", "2", "--seq", "32", "--d-model", "64",
            "--n-groups", "1", "--ckpt-dir", d, "--save-every", "5",
            "--log-every", "100"]
    l_full = train.main(args, device="cpu")
    # the second invocation restores step 10 and runs only 10..11
    l_more = train.main(args, device="cpu")
    assert len(l_more) == 2
    assert abs(l_more[-1] - l_full[-1]) < 0.2


def test_protected_flash_run_resumes_exactly(tmp_path):
    """`run` under attn_impl="flash" with protected checkpoints: flips
    injected into the saved step are corrected on restore, and the resumed
    run's losses equal an uninterrupted run's. As in the JAX driver, the
    checkpoint of step 3 holds the state after that step and the data
    position after it, and the resumed loop counts on from step 3."""
    from repro_torch.memory import uniform_flip
    _, cfg = _configs("granite_3_2b")
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    kw = dict(batch=2, seq=32, lr=5e-3, save_every=3, log=lambda m: None,
              device="cpu")
    full = train.run(cfg, steps=7, ckpt_dir=str(tmp_path / "a"), **kw)
    d = str(tmp_path / "b")
    first = train.run(cfg, steps=4, ckpt_dir=d, protect=True, **kw)
    assert ckpt.inject_storage_faults(d, uniform_flip(3, 2e-3), key=1,
                                      device="cpu") > 0
    rest = train.run(cfg, steps=6, ckpt_dir=d, protect=True, **kw)
    assert [h["step"] for h in rest] == [3, 4, 5]
    assert [h["loss"] for h in first] == [h["loss"] for h in full[:4]]
    assert [h["loss"] for h in rest] == [h["loss"] for h in full[4:]]
