"""Port parity: expert-parallel MoE (`repro_torch.nn.moe_shard`) against
the JAX package's `repro.nn.moe_shard.moe_shard_apply` on the CPU.

The JAX side runs once, in one subprocess with eight forced host devices
on a (data 2, model 4) mesh, as `tests/test_perf_paths.py`'s case does,
and hands back its weights (`init_moe`), tokens, outputs and `jax.grad`
gradients in an `.npz`; the port runs the same weights and tokens under
`use_rules` with a (2, 4) mesh that names the CPU eight times. Two
configs: the JAX test's (olmoe `.reduced(n_experts=8)`, top_k 2,
capacity_factor 8.0, nothing dropped) and capacity_factor 1.25, where
slots drop at the per-shard capacity (16 local tokens: 5 slots an
expert). Tolerances:

- the forward: `tests/test_torch_moe.py`'s atol 2**-12 (four bf16 ulps
  at outputs of about 0.009: the grouped products round in bf16 in
  another order than XLA's); bitwise equal to the port's one-device
  `moe_sorted_ep` run on each data shard's tokens;
- the gradients of sum(y²) (float32) for the router, the experts and the
  tokens: within 2**-5 of each leaf's largest |gradient|. The backward's
  bf16 products round in another order than XLA's; the largest gap
  measured is 1.5% of a leaf's largest (`tests/test_torch_archs.py`
  holds whole models' gradients to 5%).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import Mesh, use_rules
from repro_torch.nn import moe
from repro_torch.nn.moe_shard import moe_shard_apply, place_experts
from _torch_threads import torch_threads_per_worker  # noqa: F401

OUT_ATOL = 2 ** -12
GRAD_SHARE = 2 ** -5
CFS = (8.0, 1.25)
LEAVES = ("router", "w_gate", "w_up", "w_down")

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    assert len(jax.devices()) == 8, jax.devices()
    from repro.configs import get_config
    from repro.distributed.sharding import use_rules
    from repro.launch.mesh import compat_make_mesh
    from repro.nn.moe import init_moe
    from repro.nn.moe_shard import moe_shard_apply
    mesh = compat_make_mesh((2, 4), ("data", "model"))
    out = {}
    for cf in (8.0, 1.25):
        cfg = dataclasses.replace(
            get_config("olmoe_1b_7b").reduced(n_experts=8), top_k=2,
            capacity_factor=cf)
        params = init_moe(jax.random.PRNGKey(0), cfg, 32)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(size=(2, 16, cfg.d_model)).astype(
            np.float32)).astype(jnp.bfloat16)

        def loss(p, x):
            y = moe_shard_apply(p, x, cfg).astype(jnp.float32)
            return (y ** 2).sum()
        with use_rules(mesh, {"batch": "data", "expert": "model"}):
            with mesh:
                y = jax.jit(lambda p, x: moe_shard_apply(p, x, cfg))(
                    params, x)
                gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
        out[f"x{cf}"] = np.asarray(x.astype(jnp.float32))
        out[f"y{cf}"] = np.asarray(y.astype(jnp.float32))
        out[f"gx{cf}"] = np.asarray(gx.astype(jnp.float32))
        for k in params:
            out[f"{k}{cf}"] = np.asarray(params[k])
            out[f"g{k}{cf}"] = np.asarray(gp[k])
    np.savez(sys.argv[1], **out)
    print("JAX-EP-OK")
""")


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """The JAX side, from one subprocess."""
    path = tmp_path_factory.mktemp("ep") / "out.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0 and "JAX-EP-OK" in proc.stdout, proc.stderr
    return dict(np.load(path))


def _cfg(cf):
    return dataclasses.replace(get_config("olmoe_1b_7b").reduced(
        n_experts=8), top_k=2, capacity_factor=cf, moe_impl="shard_ep")


def _layer(cfg, ref, cf):
    layer = moe.MoE(cfg, 32, device="cpu")
    with torch.no_grad():
        for name, param in layer.named_parameters():
            param.copy_(torch.from_numpy(ref[f"{name}{cf}"]))
    return layer


def _mesh():
    return Mesh(np.full((2, 4), torch.device("cpu"), dtype=object),
                ("data", "model"))


@pytest.mark.parametrize("cf", CFS)
def test_expert_parallel_forward_matches(cf, jax_ep):
    cfg = _cfg(cf)
    layer = _layer(cfg, jax_ep, cf)
    x = torch.from_numpy(jax_ep[f"x{cf}"]).to(torch.bfloat16)
    with torch.no_grad(), use_rules(_mesh()):
        y = moe.moe_apply(layer, x, cfg)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), jax_ep[f"y{cf}"], rtol=0,
                               atol=OUT_ATOL)
    # each data shard is the one-device dispatch of its own 16 tokens, at
    # the capacity of 16 tokens
    x2d = x.reshape(32, -1)
    with torch.no_grad():
        per_shard = torch.cat([moe.moe_sorted_ep(layer, x2d[i:i + 16], cfg)
                               for i in (0, 16)])
        whole = moe.moe_sorted_ep(layer, x2d, cfg)
        drops = [int((~moe.dispatch(moe.route(layer, x2d[i:i + 16], cfg)[0],
                                    8, moe.capacity(16, cfg)).keep).sum())
                 for i in (0, 16)]
    assert torch.equal(y.reshape(32, -1), per_shard)
    if cf < 2:
        assert sum(drops) > 0 and not torch.equal(whole, per_shard)
    else:
        assert drops == [0, 0] and torch.equal(whole, per_shard)
    # the experts were placed once and reused
    placed = layer._placed[tuple(_mesh().devices[0])][1]
    with torch.no_grad(), use_rules(_mesh()):
        moe.moe_apply(layer, x, cfg)
    assert layer._placed[tuple(_mesh().devices[0])][1] is placed


def test_experts_placed_once_for_each_data_group(jax_ep):
    """On a mesh whose two data groups name different devices (cpu:0 and
    cpu:1, as two cards would be), each group keeps its own placement:
    a second call copies no expert slice again."""
    cfg = _cfg(1.25)
    layer = _layer(cfg, jax_ep, 1.25)
    x = torch.from_numpy(jax_ep["x1.25"]).to(torch.bfloat16)
    mesh = Mesh(np.array([[torch.device("cpu", g)] * 4 for g in (0, 1)],
                         dtype=object), ("data", "model"))
    with torch.no_grad(), use_rules(mesh):
        y = moe.moe_apply(layer, x, cfg)
        first = {devs: hit[1] for devs, hit in layer._placed.items()}
        assert sorted({d.index for devs in first for d in devs}) == [0, 1]
        again = moe.moe_apply(layer, x, cfg)
    assert len(first) == 2 and torch.equal(again, y)
    assert all(layer._placed[devs][1] is placed
               for devs, placed in first.items())
    with torch.no_grad(), use_rules(_mesh()):
        assert torch.equal(moe.moe_apply(layer, x, cfg), y)


@pytest.mark.parametrize("cf", CFS)
def test_expert_parallel_gradients_match(cf, jax_ep):
    cfg = _cfg(cf)
    layer = _layer(cfg, jax_ep, cf)
    x = torch.from_numpy(jax_ep[f"x{cf}"]).to(torch.bfloat16)
    x.requires_grad_(True)
    with use_rules(_mesh()):
        y = moe_shard_apply(layer, x, cfg)
    (y.float() ** 2).sum().backward()
    assert not hasattr(layer, "_placed")        # nothing kept under grad
    got = {k: getattr(layer, k).grad.numpy() for k in LEAVES}
    got["x"] = x.grad.float().numpy()
    for k, g in got.items():
        want = jax_ep[f"g{k}{cf}"]
        scale = float(np.abs(want).max())
        assert scale > 0 and g.shape == want.shape, k
        np.testing.assert_allclose(g, want, rtol=0, atol=GRAD_SHARE * scale,
                                   err_msg=k)


def test_without_a_model_axis_runs_the_one_device_dispatch():
    cfg = _cfg(1.25)
    layer = moe.MoE(cfg, 32, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    x = torch.randn(2, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    with torch.no_grad():
        want = moe.moe_sorted_ep(layer, x.reshape(16, -1), cfg)
        assert torch.equal(moe.moe_apply(layer, x, cfg).reshape(16, -1),
                           want)
        data_only = Mesh([torch.device("cpu")] * 2, ("data",))
        with use_rules(data_only):
            assert torch.equal(moe_shard_apply(layer, x, cfg)
                               .reshape(16, -1), want)
        with use_rules(_mesh()), pytest.raises(ValueError, match="split"):
            moe_shard_apply(layer, x[:1, :3], cfg)   # 3 tokens, 2 shards
    with pytest.raises(ValueError, match="do not split"):
        place_experts(layer, [torch.device("cpu")] * 3)
