"""The port's distribution layer against the JAX package, on the CPU.

* every rule of ``repro_torch.dist.sharding`` gives JAX's spec (a
  ``PartitionSpec`` of the port compares equal to JAX's), on
  tests/test_dist_extra.py's ``fake_mesh`` stand-ins (the rules read only
  ``mesh.shape``; hypothesis, or the repo's stub of it) and on the
  production meshes' sizes, over every leaf path of each LM family's
  full-size parameters;
* ``_maybe`` never emits an indivisible entry, and keeps every entry that
  divides (the property of tests/test_dist_extra.py);
* ``constrain`` returns its input with no mesh, on one rank, and for a
  plain tensor (every rank's global value) on a mesh of more ranks (the
  models on the mesh: tests/test_torch_mesh.py);
* the checkpoint's spec-cleaning rule (``checkpoint.clean_spec``) on hand
  cases taken from ``repro.checkpoint.checkpoint.restore_checkpoint``, and
  against JAX's restore on a one-device mesh; JAX's ``KeyError`` for an
  axis the new mesh lacks pinned (a quirk of the reference);
* ``compress`` / ``decompress`` / ``compress_with_feedback`` bit-equal to
  JAX's in f32 (and from bf16 gradients);
* ``make_compressed_dp_grad_fn`` at one rank on JAX's
  ``test_compressed_dp_matches_exact_mean`` problem, against JAX's
  function (within one quantization step) and the exact gradient;
* two and four gloo ranks (``tests/torch_dist_ranks.py``): the compressed
  mean equal to numpy's int32 sum of the per-rank quantized gradients,
  and a checkpoint saved at one rank restored on two, each rank holding
  the slice that the cleaned spec names.
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.models.gnn import models as jgm  # noqa: E402
from repro.models.recsys import autoint as jai  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.checkpoint import clean_spec  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import grad_compress as tgc  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@st.composite
def fake_mesh(draw):
    """tests/test_dist_extra.py's mesh stand-in (rules read only .shape)."""
    shape = {}
    if draw(st.booleans()):
        shape["pod"] = draw(st.sampled_from([1, 2, 3]))
    shape["data"] = draw(st.sampled_from([1, 2, 3, 4, 5, 8, 16]))
    shape["model"] = draw(st.sampled_from([1, 2, 3, 4, 7, 8, 16]))
    return SimpleNamespace(shape=shape)


def _entries(mesh):
    cands = [None, "data", "model", ("data", "model"), jshd.ALL, jshd.BATCH]
    if "pod" in mesh.shape:
        cands += ["pod", ("pod", "data")]
    return cands


@settings(max_examples=200, deadline=None)
@given(fake_mesh(), st.integers(0, 2**31 - 1))
def test_axis_rules_match_jax(mesh, seed):
    """``data_axes``, ``all_axes``, ``_resolve``, ``axis_size``, ``_maybe``,
    ``lm_batch_spec``, ``lm_cache_spec``, ``vertex_partition_spec`` and
    ``batch_shardings`` (each kind) equal JAX's on one stand-in mesh."""
    rng = np.random.default_rng(seed)
    assert tshd.data_axes(mesh) == jshd.data_axes(mesh)
    assert tshd.all_axes(mesh) == jshd.all_axes(mesh)
    cands = _entries(mesh)
    ndim = int(rng.integers(1, 5))
    shape = tuple(int(rng.integers(1, 49)) for _ in range(ndim))
    axes = tuple(cands[int(rng.integers(0, len(cands)))] for _ in range(ndim + 1))
    resolved = jshd._resolve(axes, mesh)
    assert tshd._resolve(axes, mesh) == resolved
    for entry in resolved:
        assert tshd.axis_size(entry, mesh) == jshd.axis_size(entry, mesh)
    got, want = tshd._maybe(resolved, shape, mesh), jshd._maybe(resolved, shape, mesh)
    assert got == want and isinstance(want, JP)
    batch = int(rng.integers(1, 65))
    assert tshd.lm_batch_spec(mesh, batch) == jshd.lm_batch_spec(mesh, batch)
    cfg = SimpleNamespace(n_layers=int(rng.integers(1, 9)), n_kv_heads=int(rng.integers(1, 9)),
                          head_dim=64)
    cache = int(rng.integers(1, 9)) * 64
    assert tshd.lm_cache_spec(mesh, cfg, batch, cache) == jshd.lm_cache_spec(
        mesh, cfg, batch, cache)
    assert tshd.vertex_partition_spec(ndim) == jshd.vertex_partition_spec(ndim)
    leaves = {"x": SimpleNamespace(shape=shape), "s": SimpleNamespace(shape=())}
    for kind in ("lm", "gnn", "recsys"):
        got = tshd.batch_shardings(kind, leaves, mesh)
        for k, leaf in leaves.items():
            entry = {"lm": jshd._collapse(jshd.data_axes(mesh))}.get(
                kind, jshd._collapse(jshd.all_axes(mesh)))
            want = jshd._maybe((entry,), leaf.shape, mesh) if leaf.shape else JP()
            assert got[k].spec == want and got[k].mesh is mesh


_LM_PATHS = [
    ("embed", 2), ("unembed", 2), ("layers/ln1", 2), ("layers/wq", 3), ("layers/wk", 3),
    ("layers/wv", 3), ("layers/wo", 3), ("layers/ffn/w1", 3), ("layers/ffn/w3", 3),
    ("layers/ffn/w2", 3), ("layers/moe/router", 3), ("layers/moe/w1", 4),
    ("layers/moe/w2", 4), ("layers/moe/w3", 4), ("layers/moe/shared/w1", 3),
    ("layers/moe/shared/w2", 3), ("layers/q_norm", 2), ("head", 2), ("tables", 3),
    ("attn/0/wq", 2), ("mlp/1/b", 1), ("layers/0/w_self", 2),
]


@settings(max_examples=200, deadline=None)
@given(fake_mesh(), st.sampled_from(_LM_PATHS), st.integers(0, 2**31 - 1),
       st.sampled_from(["fsdp", "zero1"]))
def test_param_specs_match_jax(mesh, path_ndim, seed, mode):
    """``lm_param_spec`` (both modes), ``gnn_param_spec`` and
    ``recsys_param_spec`` equal JAX's for every path, random shapes."""
    path, ndim = path_ndim
    rng = np.random.default_rng(seed)
    leaf = SimpleNamespace(shape=tuple(int(rng.integers(1, 64)) for _ in range(ndim)))
    for name in ("lm_param_spec", "gnn_param_spec", "recsys_param_spec"):
        got = getattr(tshd, name)(path, leaf, mesh, mode=mode)
        assert got == getattr(jshd, name)(path, leaf, mesh, mode=mode), (name, path)


def test_param_mode_is_checked():
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    with pytest.raises(ValueError):
        tshd.lm_param_spec("layers/wq", SimpleNamespace(shape=(2, 4, 4)), mesh, mode="x")
    with pytest.raises(ValueError, match="nope"):
        tshd.batch_shardings("nope", {}, mesh)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "two_pods"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen3-32b", "deepseek-moe-16b",
                                  "qwen3-moe-235b-a22b", "gat-cora", "autoint"])
def test_param_shardings_on_production_meshes(arch, multi_pod):
    """At production sizes (tests/test_dist_extra.py's
    ``test_known_spec_shapes_on_production_mesh_arithmetic``): the port's
    ``make_production_mesh`` has JAX's axes and sizes, and
    ``param_shardings`` over each family's full-size parameter paths (the
    JAX tree's, from ``abstract_params``) gives JAX's rule's spec for every
    leaf, in fsdp and zero1 modes."""
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                          else {"data": 16, "model": 16})
    assert mesh.device_mesh is None and mesh.size == (512 if multi_pod else 256)
    spec = jconfigs.get_spec(arch)
    cfg = spec.config
    if spec.family == "gnn":
        cfg = jconfigs.resolve_gnn_config(cfg, "full_graph_sm", spec.shapes["full_graph_sm"])
    abstract = {"lm": jtm.abstract_params, "gnn": jgm.abstract_params,
                "recsys": jai.abstract_params}[spec.family](cfg)
    rule = jshd._PARAM_RULES[spec.family]
    for mode in ("fsdp", "zero1"):
        got = tshd.param_shardings(spec.family, abstract, mesh, mode=mode)
        flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
        got_flat = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(
            x, tshd.NamedSharding))
        assert len(got_flat) == len(flat)
        for (kp, leaf), sh in zip(flat, got_flat):
            path = jshd._path_str(kp)
            assert sh.spec == rule(path, leaf, mesh, mode=mode), (path, sh.spec)


def test_known_specs_on_production_mesh():
    """The policy table of the module docstring, as JAX's test pins it."""
    mesh = tmesh.make_production_mesh()
    wq = SimpleNamespace(shape=(64, 5120, 8192))
    assert tshd.lm_param_spec("layers/wq", wq, mesh) == JP(None, "data", "model")
    assert tshd.lm_param_spec("layers/wq", wq, mesh, mode="zero1") == JP(None, None, "model")
    odd = SimpleNamespace(shape=(64, 5120, 8200))
    assert tshd.lm_param_spec("layers/wq", odd, mesh) == JP(None, "data", None)
    router = SimpleNamespace(shape=(64, 5120, 128))
    assert tshd.lm_param_spec("layers/moe/router", router, mesh) == JP()


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-moe-16b"])
def test_port_param_tree_takes_jax_specs(arch):
    """The port's reduced LM parameters renested as the JAX tree
    (``params_tree``) have JAX's paths, so their shardings are JAX's."""
    tcfg = tconfigs.get_spec(arch).reduced
    jparams = jtm.abstract_params(jconfigs.get_spec(arch).reduced)
    from repro_torch.models.transformer import model as ttm

    tree = ttm.params_tree(ttm.init(tcfg, device="cpu"))
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    got = tshd.param_shardings("lm", tree, mesh)
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        path = jshd._path_str(kp)
        node = got
        for part in path.split("/"):
            node = node[part]
        assert node.spec == jshd.lm_param_spec(path, leaf, mesh), path


@settings(max_examples=200, deadline=None)
@given(fake_mesh(), st.integers(0, 2**31 - 1))
def test_maybe_never_emits_indivisible_specs(mesh, seed):
    """Every kept entry's axes exist and divide their dimension; an entry
    that exists and divides is kept; the spec is truncated to the rank."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(rng.integers(1, 49)) for _ in range(int(rng.integers(1, 5))))
    cands = [c for c in _entries(mesh) if c not in (jshd.ALL, jshd.BATCH)]
    axes = tuple(cands[int(rng.integers(0, len(cands)))] for _ in range(len(shape) + 1))
    spec = tshd._maybe(axes, shape, mesh)
    assert len(spec) == len(shape)
    for a, e, dim in zip(axes, spec, shape):
        names = () if a is None else (a if isinstance(a, tuple) else (a,))
        fits = all(n in mesh.shape for n in names) and dim % tshd.axis_size(a, mesh) == 0
        assert e == (a if (a is not None and fits) else None)


def test_constrain_without_a_mesh_or_on_one_rank():
    x = torch.arange(12.0).reshape(3, 4)
    tshd.deactivate()
    assert tshd.constrain(x, (tshd.BATCH, None)) is x
    tshd.activate(tmesh.make_mesh((1, 1), ("data", "model"), device="cpu"))
    try:
        assert tshd.constrain(x, (tshd.ALL, None)) is x
        tshd.activate(tmesh.make_mesh((2, 2), ("data", "model"), device="cpu"))
        assert tshd.constrain(x, (tshd.BATCH, None)) is x
    finally:
        tshd.deactivate()
    assert tshd.active_mesh() is None


def test_train_mesh_and_placement_on_one_rank():
    """``make_train_mesh`` is (1, 1) over (data, model) in one process, with
    no DeviceMesh; placing on it moves nothing and makes no DTensor; a
    mesh of more ranks without a process group refuses to place."""
    mesh = ttrain.make_train_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is None
    x = torch.ones(4, 2)
    assert tshd.device_put(x, tshd.NamedSharding(mesh, tshd.P("data", "model"))) is x
    big = tmesh.make_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        tshd.device_put(x, tshd.NamedSharding(big, tshd.P("data")))
    sh = tshd.NamedSharding(big, tshd.P(None, ("data", "model")))
    assert [type(p).__name__ for p in sh.placements] == ["Shard", "Shard"]
    assert tshd.replicated(x, big).spec == JP()


# -- the checkpoint's spec-cleaning rule ---------------------------------------------

CLEAN_MESH = {"data": 2, "model": 4}
#: (saved spec, shape) → cleaned spec on CLEAN_MESH
CLEAN_CASES = [
    (["data", None], (4, 6), ("data", None)),
    (["model"], (6,), (None,)),  # 4 does not divide 6
    ([("data", "model"), None], (8, 3), (("data", "model"), None)),
    ([("data", "model")], (4,), (None,)),  # 8 does not divide 4
    ([None, "data", "model"], (3, 4), (None, "data", None)),  # no third dimension
    ([("data", None)], (4,), (("data", None),)),  # a None inside a tuple is skipped
    ([], (4, 4), ()),
    (["pod", "data"], (4, 4), (None, "data")),  # pod: not on the mesh (JAX raises)
    ([("pod", "data")], (4,), (None,)),
]


@pytest.mark.parametrize("spec,shape,want", CLEAN_CASES)
def test_clean_spec_hand_cases(spec, shape, want):
    mesh = SimpleNamespace(shape=CLEAN_MESH)
    assert clean_spec([tuple(p) if isinstance(p, list) else p for p in spec], shape,
                      mesh) == JP(*want)


def _jax_mesh(axes):
    return jax.make_mesh((1,) * len(axes), axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def test_clean_spec_matches_jax_restore(tmp_path):
    """JAX's restore on a one-device mesh re-lays a saved spec as
    ``clean_spec`` does."""
    from jax.sharding import NamedSharding

    saved = {"w": JP("data", None), "e": JP(("data", "model"), None), "v": JP(None, "model")}
    mesh1 = _jax_mesh(("data", "model"))
    tree = {k: jax.device_put(jnp.ones((4, 4)), NamedSharding(mesh1, s))
            for k, s in saved.items()}
    jck.save_checkpoint(tmp_path, 1, tree)
    new = _jax_mesh(("model", "data"))
    restored, _, _ = jck.restore_checkpoint(tmp_path, tree, mesh=new)
    for k, s in saved.items():
        assert clean_spec(tuple(s), (4, 4), new) == restored[k].sharding.spec, k


def test_jax_restore_raises_on_an_axis_the_mesh_lacks(tmp_path):
    """Quirk of the reference (ROADMAP §C): its rule means to drop an axis
    the new mesh lacks, but reads the axis's size first and raises
    ``KeyError``; ``clean_spec`` replicates the dimension."""
    from jax.sharding import NamedSharding

    tree = {"w": jax.device_put(jnp.ones((4, 4)), NamedSharding(_jax_mesh(("data",)),
                                                               JP("data", None)))}
    jck.save_checkpoint(tmp_path, 1, tree)
    with pytest.raises(KeyError):
        jck.restore_checkpoint(tmp_path, tree, mesh=_jax_mesh(("model",)))
    assert clean_spec(("data", None), (4, 4), _jax_mesh(("model",))) == JP(None, None)


# -- gradient compression ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_bit_equal_to_jax(dtype):
    """``compress`` → (q, scale), ``decompress`` and five rounds of
    ``compress_with_feedback`` bit-equal to JAX's; half-way values round
    to even in both."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(64, 48)).astype(np.float32)
    g[0, :4] = [127.0, 0.5, 1.5, -2.5]  # scale 1: ties at 0.5, 1.5, -2.5
    jg = jnp.asarray(g).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jq, js = jgc.compress(jg)
    tq, ts = tgc.compress(tg)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(tgc.decompress(tq, ts).numpy(),
                                  np.asarray(jgc.decompress(jq, js)))
    jres, tres = jnp.zeros(g.shape), torch.zeros(g.shape)
    for i in range(5):
        step = rng.normal(size=g.shape).astype(np.float32) * 10.0 ** -i
        jq, js, jres = jgc.compress_with_feedback(jnp.asarray(step), jres)
        tq, ts, tres = tgc.compress_with_feedback(torch.from_numpy(step), tres)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))


def test_compressed_dp_one_rank_matches_jax():
    """JAX's ``test_compressed_dp_matches_exact_mean`` problem through both
    packages at one rank: the port's mean gradient within one quantization
    step of JAX's (the two gradients round differently) and within
    ``scale/2`` of the exact one, its loss JAX's to 1e-6, and the residual
    the quantization error."""
    def jloss(p, b):
        return jnp.mean((b @ p["w"]) ** 2)

    def tloss(p, b):
        return ((b @ p["w"]) ** 2).mean()

    w = np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)
    batch = np.random.default_rng(3).normal(size=(8, 4)).astype(np.float32)
    jfn = jgc.make_compressed_dp_grad_fn(jloss, _jax_mesh(("data",)))
    want_loss, want, _ = jfn({"w": jnp.asarray(w)}, jnp.asarray(batch),
                             {"w": jnp.zeros((4, 3))})
    tfn = tgc.make_compressed_dp_grad_fn(tloss, tmesh.make_mesh((1,), ("data",), "cpu"))
    params = {"w": torch.from_numpy(w).requires_grad_(True)}
    loss, grads, res = tfn(params, torch.from_numpy(batch), {"w": torch.zeros(4, 3)})
    (exact,) = torch.autograd.grad(tloss(params, torch.from_numpy(batch)), params["w"])
    scale = float(exact.abs().max()) / 127
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(grads["w"].numpy(), np.asarray(want["w"]), rtol=0,
                               atol=scale * 1.001)
    np.testing.assert_allclose(grads["w"].numpy(), exact.numpy(), rtol=0,
                               atol=scale / 2 * 1.001)
    np.testing.assert_allclose((grads["w"] + res["w"]).numpy(), exact.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks(world, tmp_path):
    """``tests/torch_dist_ranks.py`` over ``world`` gloo ranks on the CPU
    (its docstring lists the checks); any failing rank fails the run."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"), str(world),
         str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    if world == 2:
        assert (tmp_path / "step_00000001" / "manifest.json").exists()
