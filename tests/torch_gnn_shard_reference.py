"""The JAX package's GNNs on meshes of 4 fake CPU devices, their batches
placed by ``batch_shardings("gnn")``: the reference of
``tests/test_torch_gnn_shard.py``.

    python tests/torch_gnn_shard_reference.py OUT_DIR

:func:`make_inputs` (called by the test, in its own process) draws every
graph and feature from numpy seeds and the parameters from the JAX
initialisers, and writes them to ``OUT_DIR/inputs.npz``; this script, run
with 4 fake devices, reads them and writes to ``OUT_DIR/jax.npz`` what JAX
computes on each mesh of :data:`MESHES` for each case of :data:`CASES` and
each of its archs, jitted with the batch placed by ``batch_shardings``:

* the forward's output, laid out over every axis where the mesh divides
  its rows (else whole), and the first layer's ``h`` (GraphCast's ``e``
  too) as JAX's own constraints leave them — each device's shard under
  the device's flattened index in ``mesh.devices``, with its shape;
* the loss and the gradient of every parameter of ``loss_fn``;
* the ``ValueError`` of the fused layers at a node count the mesh does
  not divide;

and two steps of JAX's trainer step (``step_fn`` under ``batch_shardings``)
for the reduced gat-cora on ``(data, model) = (4, 1)``.
``tests/torch_gnn_shard_ranks.py`` runs the port on the same inputs over 4
gloo ranks.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_mesh_reference import flat, unflat  # noqa: E402  (numpy only at import)

#: the meshes: shape and axes; the flattened (ALL) index runs row-major over
#: (pod, data, model)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
#: full-graph cases: (nodes, edges) — both divisible by 4, 94 nodes, 257 edges
GRAPHS = {"full": (160, 704), "n94": (94, 256), "e257": (96, 257)}
#: batched small graphs: (graphs, nodes each, edges each); 8 × 7 nodes put
#: graphs across ranks (14 nodes a rank) with 8 labels split over them, 6 ×
#: 14 the same (21 a rank) with 6 labels whole
BATCHED = {"graphs8": (8, 7, 12), "graphs6": (6, 14, 12)}
ARCHS = ("graphsage-reddit", "gat-cora", "pna", "graphcast")
#: config variants run beside the archs: PNA without its std aggregator
#: (whose ``1/sqrt(var + 1e-5)`` amplifies rounding ~158× near a segment of
#: equal messages), so its gradients show the mesh's own error
VARIANTS = {"pna-nostd": ("pna", {"pna_aggregators": ("mean", "max", "min")})}
#: the archs of each case (a batched case's task is per graph)
CASES = {"full": ARCHS + ("pna-nostd",), "n94": ARCHS, "e257": ARCHS + ("pna-nostd",),
         "graphs8": ("gat-cora",), "graphs6": ("graphcast",)}
#: the fused layers' archs, which refuse a node count the mesh does not divide
FUSED = ("pna", "graphcast")
TRAIN_ARCH, TRAIN_MESH = "gat-cora", (4, 1)
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 2, 3e-3, 1
D_IN = 6


def gnn_cfg(arch, case):
    """The arch's (or a :data:`VARIANTS` entry's) reduced config bound to
    the case's shape kind (a batched case's node classification becomes
    graph classification, as ``resolve_gnn_config`` binds it)."""
    from repro import configs

    import dataclasses

    arch, changes = VARIANTS.get(arch, (arch, {}))
    spec = configs.get_spec(arch)
    kind = "batched_graphs" if case in BATCHED else "full_graph"
    cfg = configs.resolve_gnn_config(spec.reduced, case, {"kind": kind, "d_feat": D_IN})
    return dataclasses.replace(cfg, **changes)


def _graph(rng, n, e):
    """Edges of ``n`` nodes in pull order: ``e`` rows, ``dst`` ascending,
    the last 3 padding rows (``src = dst = n``, masked), nodes 10–13 with
    no edge."""
    dst = np.sort(rng.integers(0, n, e - 3))
    dst = np.where((dst >= 10) & (dst < 14), 9, dst)
    src = rng.integers(0, n, e - 3)
    return (np.concatenate([src, np.full(3, n)]).astype(np.int32),
            np.sort(np.concatenate([dst, np.full(3, n)])).astype(np.int32),
            np.concatenate([rng.random(e - 3) < 0.9, np.zeros(3, bool)]))


def _batched(rng, b, n, e):
    """``b`` graphs of ``n`` nodes and ``e`` edges each as one disjoint
    union: ``dst`` ascending, each edge inside its graph, ``graph_id``
    ascending."""
    dst = np.concatenate([g * n + np.sort(rng.integers(0, n, e)) for g in range(b)])
    src = np.concatenate([g * n + rng.integers(0, n, e) for g in range(b)])
    return (src.astype(np.int32), dst.astype(np.int32), np.ones(b * e, bool),
            np.repeat(np.arange(b), n).astype(np.int32))


def make_inputs(path):
    """Every input of the reference and of the port's ranks."""
    import jax

    from repro.models.gnn import models as gm

    rng = np.random.default_rng(31)
    out = {}
    for case, archs in CASES.items():
        if case in BATCHED:
            b, n, e = BATCHED[case]
            src, dst, emask, gid = _batched(rng, b, n, e)
            n_nodes = b * n
        else:
            n_nodes, e = GRAPHS[case]
            src, dst, emask = _graph(rng, n_nodes, e)
        for i, arch in enumerate(archs):
            cfg = gnn_cfg(arch, case)
            out.update(flat(gm.init(jax.random.PRNGKey(50 + i), cfg), f"{case}/{arch}/params"))
            batch = {"x": rng.normal(size=(n_nodes, D_IN)).astype(np.float32),
                     "src": src, "dst": dst, "emask": emask}
            if case in BATCHED:
                batch["graph_id"] = gid
                batch["labels"] = (rng.normal(size=(b, cfg.n_out)).astype(np.float32)
                                   if cfg.task == "regression"
                                   else rng.integers(0, cfg.n_out, b).astype(np.int32))
            elif cfg.task == "regression":
                batch["labels"] = rng.normal(size=(n_nodes, cfg.n_out)).astype(np.float32)
                batch["lmask"] = (rng.random(n_nodes) < 0.7).astype(np.float32)
            else:
                batch["labels"] = rng.integers(0, cfg.n_out, n_nodes).astype(np.int32)
                batch["lmask"] = (rng.random(n_nodes) < 0.5).astype(np.float32)
            out.update(flat(batch, f"{case}/{arch}/batch"))
    np.savez(path, **out)


def _mesh(shape, axes):
    import jax

    from repro.dist import compat  # noqa: F401  (mesh-API shims)

    return jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(shape))


def shards(arr, mesh):
    """``{flattened device index: (shard data, shape)}`` of a jitted result:
    each device's addressable shard under its index in ``mesh.devices``."""
    index = {d: i for i, d in enumerate(mesh.devices.reshape(-1).tolist())}
    return {index[s.device]: np.asarray(s.data) for s in arr.addressable_shards}


def first_layer(params, batch, cfg):
    """The forward up to its first layer's output (``h``, and GraphCast's
    ``e``), as ``forward`` computes and constrains them."""
    import jax
    import jax.numpy as jnp

    from repro.dist.sharding import ALL, constrain
    from repro.models.gnn import layers as L

    def _c(t):
        return constrain(t, (ALL,) + (None,) * (t.ndim - 1))

    cdt = jnp.dtype(cfg.compute_dtype)
    x = _c(batch["x"].astype(cdt))
    src, dst, emask = batch["src"], batch["dst"], batch["emask"]
    n = x.shape[0]
    cast = jax.tree_util.tree_map(lambda p: p.astype(cdt), params)
    if cfg.variant == "graphcast":
        h = _c(jax.nn.silu(x @ cast["encode_node"]))
        e = _c(jax.nn.silu(jnp.ones(src.shape, cdt)[:, None] @ cast["encode_edge"]))
        lp = jax.tree_util.tree_map(lambda t: t[0], cast["layers"])
        h, e = L.mpnn_layer_fused(lp, h, e, src, dst, emask, n)
        return _c(h), _c(e)
    if cfg.variant == "pna":
        return (_c(L.pna_layer_fused(cast["layer0"], x, src, dst, emask, n,
                                     cfg.pna_aggregators, cfg.pna_scalers, cfg.pna_delta)),)
    lp = params["layers"][0]
    if cfg.variant == "sage":
        return (_c(L.sage_layer(lp, x, src, dst, emask, n, cfg.aggregator)),)
    return (_c(L.gat_layer(lp, x, src, dst, emask, n, cfg.n_heads, cfg.d_hidden)),)


def model_cases(a, res, tag, mesh):
    """Every case's forward, first layer, loss and gradients on ``mesh``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.dist import sharding as shd
    from repro.models.gnn import models as gm

    shd.activate(mesh)
    try:
        for case, archs in CASES.items():
            for arch in archs:
                key = f"{tag}/{case}/{arch}"
                cfg = gnn_cfg(arch, case)
                params = jax.tree_util.tree_map(jnp.asarray, unflat(a, f"{case}/{arch}/params"))
                batch = jax.tree_util.tree_map(jnp.asarray, unflat(a, f"{case}/{arch}/batch"))
                bshard = shd.batch_shardings("gnn", batch, mesh)
                rep = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()), params)
                for k, sh in bshard.items():
                    res[f"{key}/batch_shard/{k}"] = np.asarray(sh.shard_shape(batch[k].shape))
                n = batch["x"].shape[0]
                out_sh = NamedSharding(mesh, shd._maybe((shd._collapse(shd.all_axes(mesh)),),
                                                        (n,), mesh))
                with mesh:
                    try:
                        out = jax.jit(lambda p, b: gm.forward(p, b, cfg),
                                      in_shardings=(rep, bshard), out_shardings=out_sh)(
                                          params, batch)
                    except ValueError as err:
                        res[f"{key}/error"] = np.asarray(str(err))
                        continue
                    for i, s in shards(out, mesh).items():
                        res[f"{key}/out/{i}"] = s
                    first = jax.jit(lambda p, b: first_layer(p, b, cfg),
                                    in_shardings=(rep, bshard))(params, batch)
                    for name, t in zip(("h", "e"), first):
                        for i, s in shards(t, mesh).items():
                            res[f"{key}/{name}/{i}"] = s
                    loss, grads = jax.jit(jax.value_and_grad(
                        lambda p, b: gm.loss_fn(p, b, cfg)), in_shardings=(rep, bshard))(
                            params, batch)
                res[f"{key}/loss"] = np.asarray(loss)
                res.update(flat(jax.device_get(grads), f"{key}/grads"))
    finally:
        shd.deactivate()


def train_cases(a, res):
    """Two steps of JAX's trainer step for the reduced gat-cora on (4, 1),
    the batch placed by ``batch_shardings``."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.dist import sharding as shd
    from repro.models.gnn import models as gm
    from repro.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule

    mesh = _mesh(TRAIN_MESH, ("data", "model"))
    cfg = gnn_cfg(TRAIN_ARCH, "full")
    oc = AdamWConfig(lr=TRAIN_LR)
    params = jax.tree_util.tree_map(jnp.asarray, unflat(a, f"full/{TRAIN_ARCH}/params"))
    batch = jax.tree_util.tree_map(jnp.asarray, unflat(a, f"full/{TRAIN_ARCH}/batch"))
    state = {"params": params, "opt": adamw_init(params, oc)}
    shd.activate(mesh)
    try:
        pshard = shd.param_shardings("gnn", params, mesh)
        state_shard = {"params": pshard, "opt": {
            "m": pshard, "v": pshard, "step": shd.replicated(jnp.zeros(()), mesh)}}
        bshard = shd.batch_shardings("gnn", batch, mesh)

        @functools.partial(jax.jit, in_shardings=(state_shard, bshard),
                           out_shardings=(state_shard, None))
        def step_fn(state, batch):
            p, o = state["params"], state["opt"]
            loss, g = jax.value_and_grad(lambda p, b: gm.loss_fn(p, b, cfg))(p, batch)
            lr_scale = cosine_schedule(o["step"], warmup=TRAIN_WARMUP, total=TRAIN_STEPS)
            p, o = adamw_update(g, o, p, oc, lr_scale=lr_scale)
            return {"params": p, "opt": o}, {"loss": loss}

        losses = []
        with mesh:
            for _ in range(TRAIN_STEPS):
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
    finally:
        shd.deactivate()
    res["train/losses"] = np.asarray(losses, np.float32)
    res.update(flat(jax.device_get(state["params"]), "train/params"))
    res.update(flat(jax.device_get(state["opt"]["m"]), "train/m"))


def main(out_dir):
    a = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    res = {}
    for tag, (shape, axes) in MESHES.items():
        model_cases(a, res, tag, _mesh(shape, axes))
    train_cases(a, res)
    np.savez(os.path.join(out_dir, "jax.npz"), **{k: np.asarray(v) for k, v in res.items()})
    print("REFERENCE_OK")


if __name__ == "__main__":
    main(sys.argv[1])
