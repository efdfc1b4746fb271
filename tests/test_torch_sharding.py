"""Port parity: the device mesh (`repro_torch.distributed.sharding`,
`repro_torch.launch.mesh`) and the paths sharded over it, against the JAX
package on the CPU.

The port's meshes name the CPU more than once (2 and 3 shards); the JAX
side of the multi-device cases runs once, in one subprocess with eight
forced host devices, and hands its results back in an `.npz`. The
corrupted words are drawn with numpy and fed to both packages.
Tolerances:

- `decode_sharded`: symbols, corrected words, `detect_fail` and
  iterations exactly, against the JAX `decode_sharded` on 2 and 3
  devices and the port's unsharded decode; the LLV totals bitwise
  against the port's unsharded decode and the JAX eager decode
  (`tests/test_torch_decode.py`'s rule), and to rtol 1e-5 against the
  JAX `decode_sharded`, whose jitted body fuses the damped update in
  another order (`tests/test_torch_paged.py`'s rule);
- `scan_syndromes_sharded`: exactly, and the int32 guard's message;
- `decode_stream` / `decode_pipelined` with `mesh=`: as `decode_sharded`,
  and the JAX divisibility errors on a `SimpleNamespace(shape={"data":
  3})`, for chunks and for pages;
- a 2-shard `PagedProtectedStore`, `ProtectedPagePool` and
  `MemoryController(use_sharded=True)` on identical corrupted words:
  every read, report, stat and stored word equal to the JAX unsharded
  ones and to the port's unsharded ones, and each page held as row
  shards;
- the serving engine with `ProtectedKVConfig(mesh=2 shards)`: tokens
  equal to the unsharded port engine and to the JAX engine on
  `tests/test_torch_engine.py`'s model and traffic.
"""
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import decode_integers as jdecode
from repro.core import decode_pipelined as jpipelined
from repro.core import decode_stream as jstream
from repro.core import get_code as jget_code
from repro.core import np_encode_words
from repro.distributed import sharding as jsharding
from repro.memory import PagedProtectedStore as JStore
from repro.memory import PooledStore as JPooled
from repro.memory import ProtectedMemoryArray as JArray
from repro.memory import ProtectedPagePool as JPool
from repro.memory import StoredTensor as JStored
from repro.models import ProtectedKVConfig as JPKV
from repro.models import init_params as jinit_params
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_arrays, stored_from_arrays
from repro_torch.core import decode_integers, decode_pipelined, \
    decode_stream, get_code
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import compat_make_mesh, make_host_mesh
from repro_torch.memory import (MemoryController, PooledStore,
                                ProtectedMemoryArray, ProtectedPagePool,
                                uniform_flip)
from repro_torch.memory.paged import PagedProtectedStore
from repro_torch.models import ProtectedKVConfig
from repro_torch.serving import ServingEngine
from _torch_threads import torch_threads_per_worker  # noqa: F401

CPU = torch.device("cpu")
CODE = "wl160_r08"
B = 13                     # a multiple of neither shard count
STAT_SKIP = ("scrub_seconds", "scrub_bandwidth_cells_per_s")


def _mesh(shards):
    return sharding.Mesh([CPU] * shards, ("data",))


def _received(seed=0, rate=0.02, m=B):
    rng = np.random.default_rng(seed)
    code = jget_code(CODE)
    y = np_encode_words(rng.integers(0, code.p, (m, code.k)), code)
    hit = rng.random(y.shape) < rate
    y[hit] += rng.choice([-1, 1], hit.sum())
    return y


def _levels():
    """Stored levels of a lighter corruption: some words clean."""
    return np.remainder(_received(seed=1, rate=0.004), 3).astype(np.int8)


_JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    assert len(jax.devices()) == 8, jax.devices()
    from repro.core import decode_pipelined, decode_stream, get_code
    from repro.distributed.sharding import (decode_sharded,
                                            scan_syndromes_sharded)
    inp = np.load(sys.argv[1])
    y = jnp.asarray(inp["y"], jnp.int32)
    code = get_code("wl160_r08")
    kw = dict(n_iters=8, damping=0.3, early_exit=True)
    out = {}
    for s in (2, 3):
        mesh = Mesh(np.array(jax.devices()[:s]), ("data",))
        # jitted, as its docstring asks: eagerly, shard_map runs the
        # decoder's loop op by op (about 50 s a call here)
        yc, r = jax.jit(lambda y: decode_sharded(code, y, mesh=mesh,
                                                 **kw))(y)
        out[f"y{s}"] = np.asarray(yc)
        for f in r._fields:
            out[f"{f}{s}"] = np.asarray(getattr(r, f))
        out[f"flags{s}"] = np.asarray(scan_syndromes_sharded(
            code, jnp.asarray(inp["levels"]), mesh=mesh))
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    for name, fn in (("stream", decode_stream),
                     ("pipelined", decode_pipelined)):
        for i, (yc, r) in enumerate(fn(code, y, chunk_size=8, mesh=mesh,
                                       **kw)):
            out[f"{name}{i}_y"] = np.asarray(yc)
            out[f"{name}{i}_iterations"] = np.asarray(r.iterations)
    np.savez(sys.argv[2], **out)
    print("JAX-MESH-OK")
""")


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The JAX side of the multi-device cases, from one subprocess."""
    d = tmp_path_factory.mktemp("mesh")
    np.savez(d / "in.npz", y=_received(), levels=_levels())
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
    assert proc.returncode == 0 and "JAX-MESH-OK" in proc.stdout, \
        proc.stderr
    return dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# the mesh and the ambient mesh
# ---------------------------------------------------------------------------


def test_mesh_shape_rules_and_device_rule():
    mesh = sharding.Mesh(np.array([[CPU] * 4] * 2, dtype=object),
                         ("data", "model"))
    assert list(mesh.shape.items()) == [("data", 2), ("model", 4)]
    assert mesh.axis_names == ("data", "model") and mesh.size == 8
    assert mesh.devices.shape == (2, 4) and mesh.device == CPU
    assert len(sharding.axis_devices(mesh, "model")) == 4
    with pytest.raises(ValueError, match="mixes device types"):
        sharding.Mesh([CPU, torch.device("cuda", 0)], ("data",))
    with pytest.raises(ValueError, match="one distinct name per axis"):
        sharding.Mesh([CPU, CPU], ("data", "model"))
    if not torch.cuda.is_available():
        for fn in (sharding.data_mesh, make_host_mesh,
                   lambda: compat_make_mesh((1,), ("data",))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
    # the ambient mesh, as the JAX module's: set, nested, cleared, restored
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    assert sharding.active_mesh() is None and \
        jsharding.active_mesh() is None
    with sharding.use_rules(mesh), jsharding.use_rules(jmesh):
        assert sharding.active_mesh() is mesh
        assert jsharding.active_mesh() is jmesh
        with sharding.use_rules(None), jsharding.use_rules(None):
            assert sharding.active_mesh() is None
            assert jsharding.active_mesh() is None
        assert sharding.active_mesh() is mesh
    assert sharding.active_mesh() is None


# ---------------------------------------------------------------------------
# the sharded decode and scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 3])
def test_decode_sharded_matches(shards, jax_mesh):
    y = _received()
    code = get_code(CODE)
    kw = dict(n_iters=8, damping=0.3, early_exit=True)
    ty, tr = sharding.decode_sharded(code, torch.as_tensor(y), mesh=_mesh(
        shards), **kw)
    uy, ur = decode_integers(code, torch.as_tensor(y), **kw)
    jy, jr = jdecode(jget_code(CODE), jnp.asarray(y, jnp.int32), **kw)
    assert ty.shape == y.shape and tr.iterations.shape == (B,)
    np.testing.assert_array_equal(ty.numpy(), jax_mesh[f"y{shards}"])
    assert torch.equal(ty, uy)
    for f in ("symbols", "detect_fail", "iterations"):
        got = getattr(tr, f)
        np.testing.assert_array_equal(got.numpy(), jax_mesh[f"{f}{shards}"])
        assert torch.equal(got, getattr(ur, f)), f
    assert torch.equal(tr.llv_totals, ur.llv_totals)
    np.testing.assert_array_equal(tr.llv_totals.numpy(),
                                  np.asarray(jr.llv_totals))
    np.testing.assert_allclose(tr.llv_totals.numpy(),
                               jax_mesh[f"llv_totals{shards}"], rtol=1e-5)
    assert tr.iterations.max() > 1 and (ty.numpy() != y).any()


@pytest.mark.parametrize("shards", [2, 3])
def test_scan_syndromes_sharded_matches(shards, jax_mesh):
    code = get_code(CODE)
    levels = torch.as_tensor(_levels())
    got = sharding.scan_syndromes_sharded(code, levels, mesh=_mesh(shards))
    np.testing.assert_array_equal(got.numpy(), jax_mesh[f"flags{shards}"])
    assert torch.equal(got, MemoryController(device="cpu")._scan(code,
                                                                 levels))
    assert 0 < int(got.sum()) < B
    # the int32 guard, with the JAX package's message
    big = types.SimpleNamespace(n=128, p=4099)
    with pytest.raises(AssertionError, match="int32 bound") as jerr:
        jsharding.scan_syndromes_sharded(big, None)
    with pytest.raises(ValueError, match="int32 bound") as terr:
        sharding.scan_syndromes_sharded(big, None)
    assert str(terr.value) == str(jerr.value)


def test_decode_stream_and_pipelined_over_a_mesh(jax_mesh):
    y = _received()
    code = get_code(CODE)
    kw = dict(chunk_size=8, n_iters=8, damping=0.3, early_exit=True)
    plain = list(decode_stream(code, torch.as_tensor(y), **kw))
    for name, fn in (("stream", decode_stream),
                     ("pipelined", decode_pipelined)):
        got = list(fn(code, torch.as_tensor(y), mesh=_mesh(2), **kw))
        assert [int(g[0].shape[0]) for g in got] == [8, 5]
        for i, ((gy, gr), (py, pr)) in enumerate(zip(got, plain,
                                                     strict=True)):
            np.testing.assert_array_equal(gy.numpy(),
                                          jax_mesh[f"{name}{i}_y"])
            np.testing.assert_array_equal(
                gr.iterations.numpy(), jax_mesh[f"{name}{i}_iterations"])
            assert torch.equal(gy, py) and all(
                torch.equal(a, b) for a, b in zip(gr, pr, strict=True))


def test_mesh_divisibility_errors_match_reference():
    """Chunks and pages the mesh size does not divide raise the JAX
    package's `ValueError`s, at the call."""
    fake = types.SimpleNamespace(shape={"data": 3})
    y = _received(m=4)
    calls = (
        (lambda: jstream(jget_code(CODE), jnp.asarray(y), chunk_size=8,
                         mesh=fake),
         lambda: decode_stream(get_code(CODE), torch.as_tensor(y),
                               chunk_size=8, mesh=fake)),
        (lambda: jpipelined(jget_code(CODE), jnp.asarray(y), chunk_size=4,
                            mesh=fake),
         lambda: decode_pipelined(get_code(CODE), torch.as_tensor(y),
                                  chunk_size=4, mesh=fake)),
        (lambda: JStore("wl40_r08", page_words=8, mesh=fake),
         lambda: PagedProtectedStore("wl40_r08", page_words=8, mesh=fake,
                                     device="cpu")),
        (lambda: JPool("wl40_r08", page_words=8, mesh=fake),
         lambda: ProtectedPagePool("wl40_r08", page_words=8, mesh=fake,
                                   device="cpu")),
    )
    for jcall, tcall in calls:
        with pytest.raises(ValueError) as jerr:
            jcall()
        with pytest.raises(ValueError) as terr:
            tcall()
        assert str(terr.value) == str(jerr.value)
        assert "mesh" in str(terr.value)


# ---------------------------------------------------------------------------
# the store, the pool and the controller over a mesh
# ---------------------------------------------------------------------------


def _corrupt(rng, page, rate):
    page = np.asarray(page).astype(np.int64)
    hit = rng.random(page.shape) < rate
    page[hit] = (page[hit] + rng.integers(1, 3, hit.sum())) % 3
    return page


def _store_trio(rng, rate, m=70, page_words=16):
    """JAX, port unsharded and port 2-shard stores holding the same
    corrupted words."""
    code = jget_code(CODE)
    enc = _corrupt(rng, np_encode_words(rng.integers(0, 3, (m, code.k)),
                                        code), rate)
    kw = dict(page_words=page_words, n_iters=8)
    js = JStore(CODE, **kw)
    js.append_encoded(jnp.asarray(enc))
    ts = [PagedProtectedStore(CODE, device="cpu", mesh=mesh, **kw)
          for mesh in (None, _mesh(2))]
    for st in ts:
        st.append_encoded(torch.as_tensor(enc))
    return js, ts


def _same_stats(a, b):
    a, b = a.stats.as_dict(), b.stats.as_dict()
    for k in STAT_SKIP:
        a.pop(k), b.pop(k)
    assert a == b


def test_paged_store_over_a_mesh(rng):
    js, (us, ss) = _store_trio(rng, 0.05)
    parts = ss._stored(0)
    assert isinstance(parts, tuple) and [tuple(p.shape) for p in parts] \
        == [(8, 160)] * 2
    for i in range(js.n_pages):
        want = np.asarray(js.read_page_corrected(i))
        np.testing.assert_array_equal(ss.read_page_corrected(i).numpy(),
                                      want)
        np.testing.assert_array_equal(us.read_page_corrected(i).numpy(),
                                      want)
    assert 0 < ss.stats.uncorrectable < ss.stats.detected
    _same_stats(js, ss)
    for a, b in zip(ss.iter_corrected(depth=2), us.iter_corrected(depth=2),
                    strict=True):
        assert torch.equal(a, b)
    for (ay, ar), (by, br) in zip(ss.decode_stream(), us.decode_stream(),
                                  strict=True):
        assert torch.equal(ay, by) and all(
            torch.equal(a, b) for a, b in zip(ar, br, strict=True))
    assert torch.equal(ss.scan_flags(), us.scan_flags())
    for coalesce in (True, False):
        jr, ur, sr = (st.scrub([0, 2, 4], coalesce=coalesce)
                      for st in (js, us, ss))
        for key in ("pages", "flagged_words", "repaired_words"):
            assert sr[key] == ur[key] == jr[key], key
        assert sr["flagged_words"] > 0
    _same_stats(us, ss)
    np.testing.assert_array_equal(ss.export_words().numpy(),
                                  js.export_words())
    assert isinstance(ss._stored(4), tuple)      # rewritten as shards


def test_page_pool_over_a_mesh(rng):
    code = jget_code(CODE)
    kw = dict(page_words=4, capacity_pages=10, n_iters=8)
    jp = JPool(CODE, **kw)
    tps = [ProtectedPagePool(CODE, device="cpu", mesh=m, **kw)
           for m in (None, _mesh(2))]
    stores = []
    for owner, m in (("a", 22), ("b", 6)):
        u = rng.integers(0, 3, (m, code.k))
        row = [JPooled(jp, owner=owner)] + [PooledStore(tp, owner=owner)
                                            for tp in tps]
        row[0].append_words(jnp.asarray(u, jnp.int32))
        for st in row[1:]:
            st.append_words(torch.as_tensor(u))
        stores.append(row)
    for row in stores:
        for i in range(row[0].n_pages):
            page = _corrupt(rng, row[0].page(i), 0.01)
            row[0]._pages[i] = jnp.asarray(page, jnp.int32)
            for st in row[1:]:
                st._pages[i] = page
    assert isinstance(tps[1]._storage[0], tuple)
    for kw in ([dict(max_pages=3)] * 2 + [dict(prioritize=True)]):
        for coalesce in (True, False):
            jr = jp.scrub(coalesce=coalesce, **kw)
            for tp in tps:
                tr = tp.scrub(coalesce=coalesce, **kw)
                assert {k: tr[k] for k in jr} == jr
                assert tp.hot_pages() == jp.hot_pages()
    for pid in tps[0].allocated():
        want = np.asarray(jp.page(pid))
        for tp in tps:
            np.testing.assert_array_equal(tp.page(pid).numpy(), want)
    assert jp.scrub_by_owner["a"]["flagged_words"] > 0
    assert tps[0].scrub_by_owner == tps[1].scrub_by_owner == \
        jp.scrub_by_owner
    # a copy keeps the layout; a copy to a device is one tensor a page
    assert isinstance(tps[1].copy()._storage[0], tuple)
    assert isinstance(tps[1].copy(device="cpu")._storage[0], torch.Tensor)
    # injection draws on the pool's device: the same faults either way
    n = [tp.inject(uniform_flip(3, 0.05), key=3) for tp in tps]
    assert n[0] == n[1] > 0
    for pid in tps[0].allocated():
        assert torch.equal(tps[0].page(pid), tps[1].page(pid))


@pytest.mark.parametrize("policy", ["basic", "writeback"])
def test_sharded_controller_matches(policy, rng):
    """`MemoryController(use_sharded=True)` over a 2-shard mesh: reads,
    scrubs, storage and `ControllerStats` equal to the unsharded port
    controller and the JAX controller."""
    code = jget_code("wl40_r08")
    jm = JArray(code, controller=policy, chunk_size=32)
    ts = [ProtectedMemoryArray(get_code("wl40_r08"), controller=policy,
                               chunk_size=32, device="cpu", **kw)
          for kw in ({}, {"use_sharded": True, "mesh": _mesh(2)})]
    assert ts[1].controller.use_sharded and not ts[0].controller.use_sharded
    assert ts[1].controller.mesh.size == 2
    t = rng.normal(size=(20, 9)).astype(np.float32)
    jm.write("t", t)
    for tm in ts:
        tm.write("t", torch.as_tensor(t))
    st = jm.stored("t")
    enc = _corrupt(rng, st.enc, 0.008)
    jm.import_stored("t", JStored(enc.astype(np.int8), st.dtype, st.shape,
                                  st.nbytes))
    for tm in ts:
        tm.import_stored("t", stored_from_arrays(enc, st.dtype, st.shape,
                                                 st.nbytes, device="cpu"))
    for _ in range(2):
        want = jm.read("t")
        for tm in ts:
            assert np.array_equal(tm.read("t"), want)
    jr = jm.scrub()
    rs = [tm.scrub() for tm in ts]
    for key in ("words_scanned", "flagged", "corrected", "uncorrectable",
                "pages", "drains"):
        assert rs[0][key] == rs[1][key] == jr[key], key
    for tm in ts:
        _same_stats(jm, tm)
        assert np.array_equal(tm.stored("t").enc.numpy(), jm.stored("t").enc)
    assert jm.stats.detected > 0
    assert not MemoryController(device="cpu").use_sharded
    with pytest.raises(ValueError, match="unsharded controller has no mesh"):
        MemoryController(device="cpu", use_sharded=False, mesh=_mesh(2))


def test_kv_layer_over_a_mesh(rng):
    """A `ProtectedKVLayer` whose private stores are sharded
    (`ProtectedKVConfig(mesh=...)`): the same stored cells, corrections
    and fused reads as the unsharded layer, through an injection."""
    from repro_torch.models import ProtectedKVLayer
    layers = [ProtectedKVLayer(ProtectedKVConfig(code_name=CODE,
                                                 page_tokens=8, mesh=mesh),
                               2, 2, 16, owner="t", device="cpu")
              for mesh in (None, _mesh(2))]
    for t in (8, 11, 5):
        kv = [torch.from_numpy(rng.normal(size=(2, t, 2, 16)).astype(
            np.float32)).to(torch.bfloat16) for _ in range(2)]
        for layer in layers:
            layer.append(*kv)
    assert isinstance(layers[1].k_store._stored(0), tuple)
    assert layers[0].inject(uniform_flip(3, 0.01), key=1) == \
        layers[1].inject(uniform_flip(3, 0.01), key=1) > 0
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    a, b = (layer.attend(q) for layer in layers)
    assert torch.equal(a, b)
    assert layers[0].stats() == layers[1].stats()
    assert layers[1].stats()["corrected"] > 0
    for sa, sb in ((layers[0].k_store, layers[1].k_store),
                   (layers[0].v_store, layers[1].v_store)):
        assert torch.equal(sa.export_words(), sb.export_words())


# ---------------------------------------------------------------------------
# the engine over a mesh
# ---------------------------------------------------------------------------

TINY = dict(n_groups=2, d_model=32, n_heads=2, d_ff=64, vocab=128)


def test_engine_over_a_mesh_gives_the_same_tokens():
    """`tests/test_torch_engine.py`'s model (the JAX `init_params` as it
    is) and traffic through the port's engine with its default pool
    sharded over 2 shards, unsharded, and the JAX engine."""
    jcfg = jget_config("paper_pim").reduced(**TINY)
    cfg = get_config("paper_pim").reduced(**TINY)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12) for _ in range(4)]
    kw = dict(max_active=4, max_seq=48)
    out = {}
    for name, mesh in (("plain", None), ("mesh", _mesh(2))):
        pkv = ProtectedKVConfig(code_name=CODE, page_tokens=8, n_iters=8,
                                mesh=mesh)
        eng = ServingEngine(params, cfg, pkv=pkv, **kw)
        assert (eng.pool.mesh is None) == (mesh is None)
        for t, p in enumerate(prompts):
            eng.submit(t, p, max_new=8)
        eng.run()
        out[name] = {s.tenant: list(s.generated) for s in eng.sequences}
    jeng = JEngine(jparams, jcfg, pkv=JPKV(code_name=CODE, page_tokens=8,
                                           n_iters=8), **kw)
    for t, p in enumerate(prompts):
        jeng.submit(t, p, max_new=8)
    jeng.run()
    want = {s.tenant: [int(x) for x in s.generated] for s in jeng.sequences}
    assert out["mesh"] == out["plain"] == want
