"""The port's GNNs with their node and edge rows split over every mesh
axis, held to the JAX package's under the same mesh, on the CPU.

``tests/torch_gnn_shard_reference.py``'s ``make_inputs`` draws every input
once (numpy seeds; parameters from the JAX initialisers, carried across);
then two subprocesses run at once: the reference, JAX on 4 fake devices,
each function jitted with the batch placed by ``batch_shardings("gnn")``,
and ``tests/torch_gnn_shard_ranks.py``, the port on 4 gloo ranks, each
holding only its block of the batch (``launch.train.shard_graph``). On
``(data, model) = (2, 2)`` and ``(pod, data, model) = (2, 1, 2)``, for the
reduced SAGE, GAT, PNA and GraphCast on a graph of 160 nodes and 704 edges,
on 94 nodes (which 4 ranks do not divide), on 257 edges (likewise), and on
batched small graphs whose graphs straddle ranks (8 graphs of 7 nodes, the
8 labels split; 6 of 14, the labels whole):

* rank ``r``'s block of the output and of the first layer's ``h`` (and
  GraphCast's ``e``) is JAX's shard on the device of flattened index
  ``r``: the same shape — a block of ``N/4`` or ``E/4`` rows where the mesh
  divides them, whole where it does not — and values within ``TOL``;
* the loss within ``TOL`` and every parameter's gradient within
  ``GRAD_F32`` · max|g| (``tests/test_torch_mesh.py``'s bounds), on every
  rank, PNA with its std aggregator too;
* each rank's batch leaves are JAX's shard shapes, ``1/4`` of the whole
  where the mesh divides them, and at no layer's entry is a plain tensor of
  ``N`` or ``E`` rows alive on a rank where the mesh divides both;
* at 94 nodes the fused layers raise JAX's ``ValueError``;
* two ``Supervised`` steps of gat-cora on ``(4, 1)`` against JAX's
  ``step_fn`` under ``batch_shardings``: the losses, the parameters and the
  first moments within ``TOL``, the batch placed a quarter a rank, the step
  averaging nothing over the ranks.

In process: the dry-run of GraphCast on ``ogb_products`` as rank 0 of the
pod mesh ``single`` holds its shards of the batch and fits one card.
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
import torch_gnn_shard_reference as ref  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-5
GRAD_F32 = 1e-4
RANKS = range(4)
CASES = [(tag, case, arch) for tag in ref.MESHES for case, archs in ref.CASES.items()
         for arch in archs if not (case == "n94" and arch in ref.FUSED)]
DIVIDED = [c for c in CASES if c[1] not in ("n94", "e257")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``(jax, port)`` result dicts of the two subprocesses."""
    out = tmp_path_factory.mktemp("gnn_shard")
    ref.make_inputs(out / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {
        name: subprocess.Popen([sys.executable, str(ROOT / "tests" / script), str(out)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                               cwd=str(ROOT), env=env)
        for name, script in (("jax", "torch_gnn_shard_reference.py"),
                             ("port", "torch_gnn_shard_ranks.py"))
    }
    logs = {}
    try:
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=240)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    for name, proc in procs.items():
        assert proc.returncode == 0, f"{name}:\n{logs.get(name, '')[-6000:]}"
    return (dict(np.load(out / "jax.npz")), dict(np.load(out / "torch.npz")),
            dict(np.load(out / "inputs.npz")))


def _close(got, want, what, tol=TOL):
    """Within ``tol`` relative, or ``tol`` · max|want| absolute."""
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=what)


def _blocks(results, key):
    """Each rank's block of a result against JAX's shard of the same
    flattened index: the same shape, values within ``TOL``."""
    jax_res, port = results[:2]
    for r in RANKS:
        got, want = port[f"{key}/{r}"], jax_res[f"{key}/{r}"]
        assert got.shape == want.shape, (key, r, got.shape, want.shape)
        _close(got, want, f"{key} rank {r}")


@pytest.mark.parametrize("tag,case,arch", CASES)
def test_output_blocks(results, tag, case, arch):
    """The forward's output: each rank's rows of ``[N, n_out]`` (whole on
    every rank at 94 nodes), JAX's shard of the same device index."""
    _blocks(results, f"{tag}/{case}/{arch}/out")
    split = case != "n94"
    assert all(bool(results[1][f"{tag}/{case}/{arch}/out_flat/{r}"]) == split for r in RANKS)


@pytest.mark.parametrize("tag,case,arch", CASES)
def test_first_layer_blocks(results, tag, case, arch):
    """The first layer's ``h`` (and GraphCast's ``e``) as each rank holds
    it between layers: JAX's shard of the same device index, split where
    the mesh divides the rows (``N/4``, ``E/4``) and whole where it does
    not (94 nodes; GraphCast's 257 edges), as JAX's ``_maybe`` leaves it."""
    key = f"{tag}/{case}/{arch}"
    _blocks(results, f"{key}/h")
    n, e = (results[2][f"{case}/{arch}/batch/{k}"].shape[0] for k in ("x", "src"))
    assert results[1][f"{key}/h/0"].shape[0] == (n if n % 4 else n // 4)
    if arch == "graphcast":
        _blocks(results, f"{key}/e")
        assert results[1][f"{key}/e/0"].shape[0] == (e if e % 4 else e // 4)


@pytest.mark.parametrize("tag,case,arch", CASES)
def test_loss_and_gradients(results, tag, case, arch):
    """``loss_fn`` — JAX's global loss, the ranks' masked sums, pools and
    denominators summed over the ranks — within ``TOL`` on every rank, and
    every parameter's gradient, whole and alike on every rank, within
    ``GRAD_F32`` · max|g|, PNA with its std aggregator too."""
    jax_res, port = results[:2]
    key = f"{tag}/{case}/{arch}"
    keys = sorted(k for k in jax_res if k.startswith(f"{key}/grads/"))
    assert keys
    for r in RANKS:
        _close(port[f"{key}/loss/{r}"], jax_res[f"{key}/loss"], f"loss rank {r}")
        assert sorted(k for k in port if k.startswith(f"{key}/grads/")
                      and k.endswith(f"/{r}")) == [f"{k}/{r}" for k in keys]
        for k in keys:
            _close(port[f"{k}/{r}"], jax_res[k], f"{k} rank {r}", GRAD_F32)


@pytest.mark.parametrize("arch", ["pna", "pna-nostd"])
@pytest.mark.parametrize("case", ["full", "e257"])
def test_pna_gradient_without_a_mesh(results, case, arch):
    """PNA's gradients on one device, no mesh, with and without its std
    aggregator, within ``GRAD_F32`` · max|g| of JAX's: the bound the mesh's
    are held to. The std divides by ``sqrt(var + 1e-5)``, ~158× near a
    segment of equal messages, so rounding in another order moves these
    gradients most (an earlier draw of these inputs put the first layer's
    ``w_pre`` gradient 3.25e-4 · max|g| from JAX's)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models.gnn import models as jgm
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models.common import tensors_from_arrays
    from repro_torch.models.gnn import models as gm
    from torch_gnn_shard_ranks import _cfg
    from torch_mesh_reference import flat, unflat

    inputs = results[2]
    cfg, jcfg = _cfg(arch, case), ref.gnn_cfg(arch, case)
    params = gm.params_from_arrays(cfg, unflat(inputs, f"{case}/{arch}/params"), "cpu",
                                   trainable=True)
    batch = tensors_from_arrays(unflat(inputs, f"{case}/{arch}/batch"), torch.device("cpu"))
    _, grads = value_and_grad(lambda p, b: gm.loss_fn(p, b, cfg), params, batch)
    want = flat(jax.device_get(jax.grad(lambda p, b: jgm.loss_fn(p, b, jcfg))(
        *(jax.tree_util.tree_map(jnp.asarray, unflat(inputs, f"{case}/{arch}/{part}"))
          for part in ("params", "batch")))), "g")
    assert sorted(f"g/{k}" for k in grads) == sorted(want)
    for k, g in grads.items():
        _close(g.numpy(), want[f"g/{k}"], f"{arch} {k}", GRAD_F32)


@pytest.mark.parametrize("tag,case,arch", CASES)
def test_batch_leaves_are_jax_shards(results, tag, case, arch):
    """Each rank holds JAX's shard shape of every batch leaf under
    ``batch_shardings("gnn")``: a quarter of the rows where the mesh divides
    them (nodes, edges, a batched case's 8 labels), the whole leaf where it
    does not (94 nodes, 257 edges, 6 labels)."""
    jax_res, port = results[:2]
    key = f"{tag}/{case}/{arch}"
    leaves = sorted(k[len(f"{key}/batch_shard/"):] for k in jax_res
                    if k.startswith(f"{key}/batch_shard/"))
    assert leaves
    for k in leaves:
        whole = results[2][f"{case}/{arch}/batch/{k}"].shape
        want = tuple(jax_res[f"{key}/batch_shard/{k}"])
        assert want[0] == (whole[0] if whole[0] % 4 else whole[0] // 4)
        for r in RANKS:
            assert tuple(port[f"{key}/batch_local/{k}/{r}"]) == want, (k, r)


@pytest.mark.parametrize("tag,case,arch", DIVIDED)
def test_no_whole_rows_between_layers(results, tag, case, arch):
    """Where the mesh divides ``N`` and ``E``, no plain tensor of ``N`` or
    ``E`` rows is alive on any rank at any layer's entry: node state
    gathered whole for a region is dropped after it."""
    for r in RANKS:
        live = results[1][f"{tag}/{case}/{arch}/live_whole/{r}"]
        assert live.size == 0, (r, live.reshape(-1).tolist())


@pytest.mark.parametrize("arch", ref.FUSED)
@pytest.mark.parametrize("tag", list(ref.MESHES))
def test_fused_layers_refuse_indivisible_nodes(results, tag, arch):
    """94 nodes on 4 node shards: the forward of PNA and GraphCast raises
    JAX's ``psum_scatter(tiled=True)`` message."""
    want = str(results[0][f"{tag}/n94/{arch}/error"])
    assert "divisible" in want
    assert str(results[1][f"{tag}/n94/{arch}/error"]) == want


@pytest.mark.parametrize("part", ["losses", "params", "m"])
def test_train_steps_sharded(results, part):
    """Two ``Supervised`` steps of gat-cora on (4, 1), each rank on its
    quarter of the graph, the loss and gradients global sums (no average
    over the ranks), against JAX's ``step_fn`` under ``batch_shardings``:
    the losses, the parameters and the first moments within ``TOL`` on
    every rank."""
    jax_res, port = results[:2]
    keys = sorted(k for k in jax_res if k == f"train/{part}" or k.startswith(f"train/{part}/"))
    assert keys
    for r in RANKS:
        for k in keys:
            _close(port[f"{k}/{r}"], jax_res[k], f"{k} rank {r}")
        placed = port[f"train/placed/{r}"]
        assert (placed[:, 0] * 4 == placed[:, 1]).all()
        assert bool(port[f"train/group_none/{r}"])


def test_dryrun_graphcast_ogb_products_fits_a_rank():
    """GraphCast on ogb_products traced as rank 0 of ``single`` (16 × 16):
    its arguments are its shards of the batch (every leaf a 256th: the
    padded 2,449,920 nodes and 61,859,840 edges divide) beside the whole
    parameters and moments, and the predicted peak fits one card."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.gnn import models as gm
    from repro_torch.optim import named_leaves

    rec = dryrun.dryrun_cell("graphcast", "ogb_products", "single", device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    spec = configs.get_spec("graphcast")
    shape = spec.shapes["ogb_products"]
    cfg = configs.resolve_gnn_config(spec.config, "ogb_products", shape)
    n, e = dryrun.gnn_graph_size(shape)
    assert n % 256 == 0 and e % 256 == 0
    batch = gm.input_specs(cfg, "full_graph", "cpu", n_nodes=n, n_edges=e,
                           d_feat=shape["d_feat"])
    params = gm.abstract_params(cfg, "cpu")
    param_bytes = sum(t.numel() * t.element_size() for t in named_leaves(params).values())
    shards = sum(t.numel() * t.element_size() for t in batch.values()) // 256
    assert rec["memory"]["argument_bytes"] == 3 * param_bytes + 4 + shards
    assert rec["memory"]["fits"]
    assert rec["memory"]["peak_per_device_bytes"] < rec["memory"]["hbm_bytes"]


def test_rows_mm_pads_half_products_for_the_card(monkeypatch):
    """GraphCast's encoders and every GNN's head go through ``_rows_mm``:
    on the card a bf16 product with a dimension that is not a multiple of 8
    is zero-padded to one, so that a rank's block of rows rounds as the
    whole does (the card's kernels' property, held by the smoke's mesh
    phase). The padded product is the product: with the card's branch
    taken on the CPU, of the same shape and within bf16 rounding of the f32
    product; off the card, ``x @ w`` itself."""
    import torch

    from repro_torch.models.gnn import models as gm

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(37, 1433, generator=gen).bfloat16()
    w = (torch.randn(1433, 227, generator=gen) / 1433 ** 0.5).bfloat16()
    assert torch.equal(gm._rows_mm(x, w), x @ w)
    monkeypatch.setattr(gm.fake, "on_card", lambda t: True)
    got = gm._rows_mm(x, w)
    assert got.shape == (37, 227) and got.dtype == torch.bfloat16
    _close(got.float().numpy(), (x.float() @ w.float()).numpy(), "padded product", 3e-2)
    aligned = w[:, :224]
    assert torch.equal(gm._rows_mm(x[:, :1432], aligned[:1432]), x[:, :1432] @ aligned[:1432])
