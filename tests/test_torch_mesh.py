"""The port's models on a multi-rank mesh against the JAX package's under
the same mesh, on the CPU.

``tests/torch_mesh_reference.py``'s ``make_inputs`` draws every input once
(numpy seeds; parameters from the JAX initialisers, carried across); then
two subprocesses run at once: the reference, JAX on 4 fake devices, and
``tests/torch_mesh_ranks.py``, the port on 4 gloo ranks. Each case below
holds one of the port's results (rank 0's; DTensors gathered whole) to
JAX's, values and gradients:

* ``mp_gather`` (clip and fill), ``mp_segment_reduce`` with every combiner
  (f32 sum, prod, max, min with planted ties; int32 sum, max, min; bool or,
  and) and ``mp_edge_softmax`` on ``("data", "model") = (2, 2)``, at
  E = 256 and at an odd E = 257 (padded to whole shards), with masks,
  sentinel ids and empty segments, and the float ops' gradients — among
  them JAX's ``_diff_pminmax`` cotangent, which its transpose divides by
  the 4 ranks;
* ``pna_layer_fused`` and ``mpnn_layer_fused`` and their gradients, fused
  (E = 256) and falling back to the composable layers (E = 257), and the
  ``ValueError`` of both at 94 nodes, which 4 node shards do not divide;
* ``moe_ffn`` (expert-parallel, capacity per data shard, drops, a shared
  expert), its ``aux`` and its gradients;
* ``constrain`` on the mesh (a DTensor relaid by each spec, a plain
  tensor cut to its rank's rows, values kept);
* the reduced GNN forwards (PNA and GraphCast fused; each rank's rows
  gathered whole) and a reduced deepseek-moe prefill;
* two steps of the trainer (``Supervised`` against JAX's ``step_fn`` on
  ``(4, 1)``): the losses, the parameters and first moments after them —
  gat-cora, deepseek-moe (rows split, and a batch whole), the dense
  h2o-danube on its FSDP-sharded state and AutoInt with its tables whole.

Tolerances: exact for int, bool, min, max, or and and; ``TOL`` (f32 2e-5,
tests/test_kernels.py's) relative, or ``TOL`` · max|JAX's| absolute (sums
of many terms in other orders, as tests/test_torch_train.py scales it), for
float sums, products, the softmax, the ops' gradients and every output;
a whole layer's or model's gradients within tests/test_torch_train.py's
``GRAD_F32`` = 1e-4 · max|g| (PNA's std aggregator divides by
``sqrt(var + 1e-5)``, ~158× near a one-edge segment: the port's
one-device ``pna_layer`` already differs from JAX's by up to
4.1e-5 · max|g| on these inputs, with no mesh).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_reference as ref  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-5


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``(jax, port)`` result dicts of the two subprocesses."""
    out = tmp_path_factory.mktemp("mesh")
    ref.make_inputs(out / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {
        name: subprocess.Popen([sys.executable, str(ROOT / "tests" / script), str(out)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                               cwd=str(ROOT), env=env)
        for name, script in (("jax", "torch_mesh_reference.py"),
                             ("port", "torch_mesh_ranks.py"))
    }
    logs = {}
    try:
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=120)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    for name, proc in procs.items():
        assert proc.returncode == 0, f"{name}:\n{logs.get(name, '')[-6000:]}"
    return (dict(np.load(out / "jax.npz")), dict(np.load(out / "torch.npz")),
            dict(np.load(out / "inputs.npz")))


GRAD_F32 = 1e-4


def _close(got, want, what, tol=TOL):
    """Within ``tol`` relative, or ``tol`` · max|want| absolute."""
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=what)


MP_EXACT = [f"mp/{tag}/seg_{op}_{kind}" for tag in ref.EDGES for op, kind in (
    ("max", "f"), ("min", "f"), ("sum", "i"), ("max", "i"), ("min", "i"),
    ("or", "b"), ("and", "b"))] + [f"mp/{tag}/gather_{m}" for tag in ref.EDGES
                                   for m in ("clip", "fill")]
MP_FLOAT = [f"mp/{tag}/{name}" for tag in ref.EDGES for name in (
    "seg_sum_f", "seg_prod_p", "softmax", "grad_sum", "grad_max", "grad_min",
    "grad_gather", "grad_softmax")]


@pytest.mark.parametrize("key", MP_EXACT)
def test_mp_ops_exact(results, key):
    """Integer, boolean, extremum and gather results: bit-equal to JAX's,
    dtype and shape included, and the same on every rank."""
    want, got = results[0][key], results[1][key]
    assert got.dtype == want.dtype and got.shape == want.shape, key
    np.testing.assert_array_equal(got, want, err_msg=key)
    if "seg_" in key:
        assert bool(results[1][f"same/{key}"])


@pytest.mark.parametrize("key", MP_FLOAT)
def test_mp_ops_float(results, key):
    """Float sums, the prod (JAX's psum of the ranks' partial products),
    the softmax and every gradient within ``TOL`` of JAX's."""
    _close(results[1][key], results[0][key], key)


def test_mp_prod_sums_partial_products(results):
    """Pinned quirk of the reference: on the mesh ``prod`` adds the ranks'
    partial products (``psum``), so an empty segment is 4 (each rank's
    identity 1), not 1."""
    got = results[1]["mp/e256/seg_prod_p"]
    empty = slice(40, 56)
    np.testing.assert_array_equal(got[empty], np.full_like(got[empty], 4.0))


@pytest.mark.parametrize("op", ["max", "min"])
def test_mp_extremum_gradient_divided_over_ranks(results, op):
    """Pinned quirk of the reference: ``_diff_pminmax``'s output is
    replicated, so JAX's transpose hands each rank a quarter of the
    cotangent, and the mesh's gradient of a max or min is a quarter of the
    one-device gradient (the port's ``segment_reduce`` without a mesh)."""
    import torch

    from repro_torch.graph import ops as gops

    inputs = results[2]
    v = torch.from_numpy(inputs["e256/vf"]).requires_grad_(True)
    r = gops.segment_reduce(v, torch.from_numpy(inputs["e256/dst"]), ref.N_NODES, op,
                            mask=torch.from_numpy(inputs["e256/mask"]))
    (torch.where(torch.isfinite(r), r, 0.0) * torch.from_numpy(inputs["w_nodes"])).sum(
    ).backward()
    _close(4 * results[1][f"mp/e256/grad_{op}"], v.grad.numpy(), op)


@pytest.mark.parametrize("case", [str(i) for i in range(6)] + ["plain", "edges"])
def test_constrain_on_mesh(results, case):
    """``constrain`` on the (2, 2) mesh never changes a value: a DTensor is
    laid out by each spec as JAX's ``_maybe`` cleans it (gathered whole by
    ``dist.collectives.full_tensor``, equal to the logical array); a plain
    tensor constrained to rows over every axis becomes this rank's block
    (a flat DTensor), to another spec it comes back as it is; a region's
    edge rows stay split where the mesh divides them and are gathered
    whole where it does not."""
    assert bool(results[1][f"constrain/{case}"])


@pytest.mark.parametrize("tag", list(ref.EDGES))
def test_region_offsets_are_each_ranks_own(results, tag):
    """Every rank's offsets, cut from the global ones, equal those of its own
    rows of the ids (the card reads only the offsets)."""
    assert all(bool(results[1][f"offsets/{tag}/{r}"]) for r in range(4))


LAYER_KEYS = [f"{layer}/{tag}/{name}" for tag in ref.EDGES for layer, names in (
    ("pna", ("out", "grad_x", "grad_p/w", "grad_p/b", "grad_p/w_pre")),
    ("mpnn", ("x", "e", "grad_x", "grad_e", "grad_p/edge_w1", "grad_p/edge_w2",
              "grad_p/node_w1", "grad_p/node_w2"))) for name in names]


@pytest.mark.parametrize("key", LAYER_KEYS)
def test_fused_layers(results, key):
    """``pna_layer_fused`` / ``mpnn_layer_fused`` and their gradients: the
    fused region at E = 256, the composable layers at E = 257. The fused
    PNA's max/min gradient reaches only the ranks that hold the node's rows
    and attain the extremum — the reference's own (a one-device layer
    differs): held to JAX under the mesh."""
    _close(results[1][key], results[0][key], key, GRAD_F32 if "/grad_" in key else TOL)
    if key.endswith("/out"):
        assert bool(results[1][f"same/{key}"])


@pytest.mark.parametrize("layer", ["pna", "mpnn"])
def test_fused_layers_refuse_indivisible_nodes(results, layer):
    """94 nodes on 4 node shards: JAX's ``psum_scatter(tiled=True)`` raises a
    ``ValueError``; the port raises the same message."""
    want = str(results[0][f"{layer}/n94_error"])
    assert "divisible" in want
    assert str(results[1][f"{layer}/n94_error"]) == want


MOE_KEYS = ["moe/y", "moe/aux", "moe/grad_x"] + [f"moe/grad_p/{k}" for k in (
    "router", "w1", "w2", "w3", "shared/w1", "shared/w2", "shared/w3")]


@pytest.mark.parametrize("key", MOE_KEYS)
def test_moe_ffn_expert_parallel(results, key):
    """``moe_ffn`` on (2, 2): EP with capacity per data shard and drops,
    its balance loss pmean'd over data, and every gradient, within ``TOL``
    of JAX's ``moe_ffn`` under the same mesh."""
    _close(results[1][key], results[0][key], key)


def test_moe_drops_per_data_shard(results):
    """Each rank routes its data shard's 32 tokens (2 slots each) at the
    shard's capacity and drops some (capacity factor 0.5); the two model
    ranks of a data shard route alike."""
    counts = [results[1][f"moe/dropped/{r}"] for r in range(4)]
    assert all(int(c[0]) == (ref.MOE_T // 2) * ref.MOE["top_k"] for c in counts)
    assert all(int(c[1]) > 0 for c in counts)
    assert (counts[0] == counts[1]).all() and (counts[2] == counts[3]).all()
    assert bool(results[1]["same/moe/y"])


@pytest.mark.parametrize("arch", list(ref.GNN_ARCHS))
def test_gnn_forward_on_mesh(results, arch):
    """The reduced GNN forwards (PNA and GraphCast through their fused
    layers) within ``TOL`` of JAX's under the mesh, on every rank alike."""
    key = f"gnn/{arch}/out"
    _close(results[1][key], results[0][key], key)
    assert bool(results[1][f"same/{key}"])


def test_moe_prefill_on_mesh(results):
    """The reduced deepseek-moe prefill (tensor-parallel over ``model``, EP
    in every layer) within ``TOL`` of JAX's logits under the mesh: each
    rank's vocabulary block gathered whole, alike on every rank."""
    _close(results[1]["lm/logits"], results[0]["lm/logits"], "lm/logits")
    assert bool(results[1]["same/lm/logits"])


TRAIN_KEYS = [(arch, part) for arch in ref.TRAIN_ARCHS for part in ("losses", "params", "m")]


@pytest.mark.parametrize("arch,part", TRAIN_KEYS)
def test_train_steps_on_mesh(results, arch, part):
    """Two ``Supervised`` steps on (4, 1) against JAX's ``step_fn`` there
    (an LM's or AutoInt's batch of 4 or 16 rows split over the ranks, an
    LM's of 2 rows whole): the losses, and every parameter and first moment
    after them (the shards gathered whole), within ``TOL``; the LM's
    checkpointed parameters sharded (FSDP) as JAX's rules place them, and
    held so (AutoInt's tables whole: JAX's rule gives them ``P()``)."""
    jax_res, port = results[:2]
    prefix = f"train/{arch}/{part}"
    keys = sorted(k for k in jax_res if k == prefix or k.startswith(prefix + "/"))
    assert keys and keys == sorted(k for k in port if k == prefix or k.startswith(
        prefix + "/"))
    for k in keys:
        _close(port[k], jax_res[k], k)
    # the model on the mesh unless the ranks split the batch's rows
    assert bool(port[f"train/{arch}/on_mesh"]) == (arch in ("gat-cora", "deepseek-moe-16b@2"))
    lm = arch not in ("gat-cora", "autoint")
    assert (int(port[f"train/{arch}/sharded"]) > 0) == lm
    assert (len(port[f"train/{arch}/held"]) > 0) == lm
