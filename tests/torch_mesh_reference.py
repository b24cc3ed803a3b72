"""The JAX package's models on a mesh of 4 fake CPU devices: the reference
of ``tests/test_torch_mesh.py``.

    python tests/torch_mesh_reference.py OUT_DIR

:func:`make_inputs` (called by the test, in its own process) draws every
input from numpy seeds and the parameters from the JAX initialisers, and
writes them to ``OUT_DIR/inputs.npz``; this script, run with 4 fake devices,
reads them and writes what JAX computes under each mesh to
``OUT_DIR/jax.npz``: the ``mp_*`` ops (every combiner, values and
gradients) and the fused GNN layers, ``moe_ffn`` with drops, reduced GNN
forwards and a reduced MoE prefill on ``("data", "model") = (2, 2)``, and
two steps of JAX's trainer step on ``(4, 1)``. ``tests/torch_mesh_ranks.py``
runs the port on the same inputs over 4 gloo ranks.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


import numpy as np  # noqa: E402

N_NODES = 96
EDGES = {"e256": 256, "e257": 257}
#: PNA's aggregators and scalers in the layer cases
PNA_AGGS = ("mean", "max", "min", "std")
PNA_SCALERS = ("identity", "amplification", "attenuation")
PNA_DELTA = 2.5
D = 8
#: the MoE layer case: drops (capacity factor 0.5), a shared expert
MOE = dict(n_experts=8, top_k=2, d_ff_expert=16, n_shared_experts=1, capacity_factor=0.5)
MOE_T, MOE_D = 64, 32
GNN_ARCHS = ("graphsage-reddit", "gat-cora", "pna", "graphcast")
#: the trainer's cases on (4, 1): "@2" takes each LM batch's first 2 rows,
#: which 4 data ranks do not divide (the batch then stays whole, the MoE
#: layers split its tokens), where the 4 rows of the others are split (the
#: dense LM's over its FSDP-sharded state, AutoInt's over its whole tables)
TRAIN_ARCHS = ("gat-cora", "deepseek-moe-16b", "deepseek-moe-16b@2", "h2o-danube-1.8b",
               "autoint")
#: the LM cases' parameters (drawn by the JAX initialisers)
LM_ARCHS = ("deepseek-moe-16b", "h2o-danube-1.8b")
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 2, 3e-3, 1
LM_BATCH, LM_SEQ = 4, 16
#: AutoInt's rows a step (4 ranks, 4 rows each)
RECSYS_BATCH = 16


def flat(tree, prefix):
    """``{prefix/path: array}`` over a tree of dicts and lists."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
    elif tree is not None:
        out[prefix] = np.asarray(tree)
    return out


def unflat(arrays, prefix):
    """The tree under ``prefix`` (digit keys make lists)."""
    root = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = root, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return fix(root)


def gnn_cfg(arch):
    from repro import configs

    spec = configs.get_spec(arch)
    return configs.resolve_gnn_config(spec.reduced, "full_graph_sm", {
        "n_nodes": 64, "n_edges": 512, "d_feat": spec.reduced.d_in})


def moe_cfg():
    from repro.models.transformer.config import MoEConfig

    return MoEConfig(**MOE)


def make_inputs(path):
    """Every input of the reference and of the port's ranks."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.data.pipeline import gnn_full_batch, recsys_batches, token_batches
    from repro.models.gnn import layers as L
    from repro.models.gnn import models as gm
    from repro.models.recsys import autoint
    from repro.models.transformer import model as tm
    from repro.models.transformer import moe as moe_mod

    rng = np.random.default_rng(0)
    n = N_NODES
    out = {"field": rng.normal(size=(n, 3)).astype(np.float32),
           "w_nodes": rng.normal(size=(n, 3)).astype(np.float32),
           "x": rng.normal(size=(n, D)).astype(np.float32),
           "w_x": rng.normal(size=(n, D)).astype(np.float32)}
    for tag, e in EDGES.items():
        dst = np.sort(rng.integers(0, n, e))
        dst = np.where((dst >= 40) & (dst < 56), 39, dst)  # 16 empty segments
        dst[-6:] = n  # padding edges: the sentinel id
        src = rng.integers(0, n, e)
        src[:4] = [-1, n, n + 3, 0]  # clip / fill reads
        out.update({
            f"{tag}/dst": np.sort(dst).astype(np.int32),
            f"{tag}/src": src.astype(np.int32),
            f"{tag}/mask": rng.random(e) < 0.85,
            f"{tag}/vf": (np.round(rng.normal(size=(e, 3)) * 2) / 2).astype(np.float32),
            f"{tag}/vp": (1.0 + 0.1 * rng.normal(size=(e, 3))).astype(np.float32),
            f"{tag}/vi": rng.integers(-4, 5, (e, 2)).astype(np.int32),
            f"{tag}/vb": rng.random((e, 2)) < 0.3,
            f"{tag}/scores": rng.normal(size=(e, 2)).astype(np.float32),
            f"{tag}/w_edges": rng.normal(size=(e, D)).astype(np.float32),
            f"{tag}/e_feat": rng.normal(size=(e, D)).astype(np.float32),
        })
    out.update(flat(L.init_pna_layer(jax.random.PRNGKey(3), D, D, len(PNA_AGGS),
                                     len(PNA_SCALERS), jnp.float32), "pna_p"))
    out.update(flat(L.init_mpnn_layer(jax.random.PRNGKey(4), D, D, jnp.float32), "mpnn_p"))
    out.update(flat(moe_mod.init_moe_params(jax.random.PRNGKey(5), MOE_D, moe_cfg(),
                                            jnp.float32), "moe_p"))
    out["moe/x"] = rng.normal(size=(MOE_T, MOE_D)).astype(np.float32)
    out["moe/w_y"] = rng.normal(size=(MOE_T, MOE_D)).astype(np.float32)
    for arch in GNN_ARCHS:
        cfg = gnn_cfg(arch)
        out.update(flat(gm.init(jax.random.PRNGKey(6), cfg), f"gnn/{arch}/params"))
        batch = gnn_full_batch(64, 6.0, cfg.d_in, cfg.n_out, seed=1, task=cfg.task,
                               n_out=cfg.n_out)
        e = batch["src"].shape[0]
        pad = -e % 4  # whole edge shards: the fused layers' branch
        for k, v in batch.items():
            v = np.asarray(v)
            if k in ("src", "dst"):
                v = np.concatenate([v, np.full(pad, 64, v.dtype)])
            elif k == "emask":
                v = np.concatenate([v, np.zeros(pad, bool)])
            out[f"gnn/{arch}/batch/{k}"] = v
    lm = configs.get_spec("deepseek-moe-16b").reduced
    out.update(flat(tm.init(jax.random.PRNGKey(7), lm), "lm/params"))
    out["lm/tokens"] = rng.integers(0, lm.vocab_size, (2, 16)).astype(np.int32)
    for arch in LM_ARCHS:
        cfg = configs.get_spec(arch).reduced
        if arch != "deepseek-moe-16b":
            out.update(flat(tm.init(jax.random.PRNGKey(8), cfg), f"train/{arch}/params"))
        data = token_batches(LM_BATCH, LM_SEQ, cfg.vocab_size, seed=2)
        for i in range(TRAIN_STEPS):
            for k, v in next(data).items():
                out[f"train/{arch}/batch{i}/{k}"] = np.asarray(v)
    rec = configs.get_spec("autoint").reduced
    out.update(flat(autoint.init(jax.random.PRNGKey(9), rec), "train/autoint/params"))
    data = recsys_batches(RECSYS_BATCH, rec.n_fields, rec.vocab_per_field, seed=3)
    for i in range(TRAIN_STEPS):
        for k, v in next(data).items():
            out[f"train/autoint/batch{i}/{k}"] = np.asarray(v)
    np.savez(path, **out)


def train_case(case):
    """``(arch, rows)`` of a ``TRAIN_ARCHS`` case: the LM batch's first
    ``rows`` rows (``None``: all)."""
    arch, _, rows = case.partition("@")
    return arch, int(rows) if rows else None


def train_params_key(arch):
    """Where ``make_inputs`` put a train case's parameters."""
    return "lm/params" if arch == "deepseek-moe-16b" else f"train/{arch}/params"


def _mesh(shape):
    import jax

    from repro.dist import compat  # noqa: F401  (mesh-API shims)

    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _on(mesh, fn, *args):
    from repro.dist import sharding as shd

    shd.activate(mesh)
    try:
        with mesh:
            return fn(*args)
    finally:
        shd.deactivate()


def mp_cases(a, res, mesh):
    """The ``mp_*`` ops: every combiner's values, the float ones' gradients."""
    import jax
    import jax.numpy as jnp

    from repro.graph import ops as gops

    n = N_NODES
    w_nodes = jnp.asarray(a["w_nodes"])
    for tag in EDGES:
        src, dst, mask = (jnp.asarray(a[f"{tag}/{k}"]) for k in ("src", "dst", "mask"))
        vals = {"f": a[f"{tag}/vf"], "p": a[f"{tag}/vp"], "i": a[f"{tag}/vi"],
                "b": a[f"{tag}/vb"]}
        for kind, ops in (("f", ("sum", "max", "min")), ("p", ("prod",)),
                          ("i", ("sum", "max", "min")), ("b", ("or", "and"))):
            for op in ops:
                fn = jax.jit(lambda v, op=op: gops.mp_segment_reduce(v, dst, n, op, mask=mask))
                res[f"mp/{tag}/seg_{op}_{kind}"] = _on(mesh, fn, jnp.asarray(vals[kind]))
        for op in ("sum", "max", "min"):
            def loss(v, op=op):
                r = gops.mp_segment_reduce(v, dst, n, op, mask=mask)
                return jnp.sum(jnp.where(jnp.isfinite(r), r, 0.0) * w_nodes)

            res[f"mp/{tag}/grad_{op}"] = _on(mesh, jax.jit(jax.grad(loss)),
                                             jnp.asarray(vals["f"]))
        field, w_e = jnp.asarray(a["field"]), jnp.asarray(a[f"{tag}/w_edges"][:, :3])
        res[f"mp/{tag}/gather_clip"] = _on(mesh, jax.jit(lambda f: gops.mp_gather(f, src)), field)
        res[f"mp/{tag}/gather_fill"] = _on(
            mesh, jax.jit(lambda f: gops.mp_gather(f, src, fill=-7.0)), field)
        res[f"mp/{tag}/grad_gather"] = _on(mesh, jax.jit(jax.grad(
            lambda f: jnp.sum(gops.mp_gather(f, src) * w_e))), field)
        scores = jnp.asarray(a[f"{tag}/scores"])
        w_s = w_e[:, :2]
        res[f"mp/{tag}/softmax"] = _on(mesh, jax.jit(
            lambda s: gops.mp_edge_softmax(s, dst, n, mask=mask)), scores)
        res[f"mp/{tag}/grad_softmax"] = _on(mesh, jax.jit(jax.grad(
            lambda s: jnp.sum(gops.mp_edge_softmax(s, dst, n, mask=mask) * w_s))), scores)


def layer_cases(a, res, mesh):
    """``pna_layer_fused`` and ``mpnn_layer_fused``: outputs and gradients on
    whole edge shards (E = 256), the composable fallback (E = 257), and
    node counts the mesh does not divide."""
    import jax
    import jax.numpy as jnp

    from repro.models.gnn import layers as L

    n = N_NODES
    x, w_x = jnp.asarray(a["x"]), jnp.asarray(a["w_x"])
    pna_p = jax.tree_util.tree_map(jnp.asarray, unflat(a, "pna_p"))
    mpnn_p = jax.tree_util.tree_map(jnp.asarray, unflat(a, "mpnn_p"))
    for tag in EDGES:
        src, dst, mask = (jnp.asarray(a[f"{tag}/{k}"]) for k in ("src", "dst", "mask"))
        src = jnp.clip(src, 0, n - 1)
        w_e, e_feat = jnp.asarray(a[f"{tag}/w_edges"]), jnp.asarray(a[f"{tag}/e_feat"])

        def pna(p, x):
            return L.pna_layer_fused(p, x, src, dst, mask, n, PNA_AGGS, PNA_SCALERS, PNA_DELTA)

        res[f"pna/{tag}/out"] = _on(mesh, jax.jit(pna), pna_p, x)
        gp, gx = _on(mesh, jax.jit(jax.grad(lambda p, x: jnp.sum(pna(p, x) * w_x),
                                            argnums=(0, 1))), pna_p, x)
        res.update(flat(gp, f"pna/{tag}/grad_p"))
        res[f"pna/{tag}/grad_x"] = gx

        def mpnn(p, x, e):
            return L.mpnn_layer_fused(p, x, e, src, dst, mask, n)

        xn, en = _on(mesh, jax.jit(mpnn), mpnn_p, x, e_feat)
        res[f"mpnn/{tag}/x"], res[f"mpnn/{tag}/e"] = xn, en

        def mpnn_loss(p, x, e):
            xn, en = mpnn(p, x, e)
            return jnp.sum(xn * w_x) + jnp.sum(en * w_e)

        gp, gx, ge = _on(mesh, jax.jit(jax.grad(mpnn_loss, argnums=(0, 1, 2))),
                         mpnn_p, x, e_feat)
        res.update(flat(gp, f"mpnn/{tag}/grad_p"))
        res[f"mpnn/{tag}/grad_x"], res[f"mpnn/{tag}/grad_e"] = gx, ge
    # 94 nodes on 4 shards: psum_scatter(tiled) refuses them
    src, dst, mask = (jnp.asarray(a[f"e256/{k}"]) for k in ("src", "dst", "mask"))
    m = 94
    for name, fn in (
        ("pna", lambda: L.pna_layer_fused(pna_p, x[:m], jnp.clip(src, 0, m - 1),
                                          jnp.minimum(dst, m), mask, m, PNA_AGGS,
                                          PNA_SCALERS, PNA_DELTA)),
        ("mpnn", lambda: L.mpnn_layer_fused(mpnn_p, x[:m], jnp.asarray(a["e256/e_feat"]),
                                            jnp.clip(src, 0, m - 1), jnp.minimum(dst, m),
                                            mask, m)),
    ):
        try:
            _on(mesh, jax.jit(fn))
            res[f"{name}/n94_error"] = np.asarray("")
        except ValueError as err:
            res[f"{name}/n94_error"] = np.asarray(str(err))


def moe_cases(a, res, mesh):
    """``moe_ffn`` on the mesh: EP with per-shard capacity and drops."""
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import moe as moe_mod

    mcfg = moe_cfg()
    p = jax.tree_util.tree_map(jnp.asarray, unflat(a, "moe_p"))
    x, w_y = jnp.asarray(a["moe/x"]), jnp.asarray(a["moe/w_y"])
    y, aux = _on(mesh, jax.jit(lambda p, x: moe_mod.moe_ffn(x, p, mcfg)), p, x)
    res["moe/y"], res["moe/aux"] = y, aux

    def loss(p, x):
        y, aux = moe_mod.moe_ffn(x, p, mcfg)
        return jnp.sum(y * w_y) + aux

    gp, gx = _on(mesh, jax.jit(jax.grad(loss, argnums=(0, 1))), p, x)
    res.update(flat(gp, "moe/grad_p"))
    res["moe/grad_x"] = gx


def model_cases(a, res, mesh):
    """Reduced GNN forwards and a reduced MoE prefill."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models.gnn import models as gm
    from repro.models.transformer import model as tm

    for arch in GNN_ARCHS:
        cfg = gnn_cfg(arch)
        params = jax.tree_util.tree_map(jnp.asarray, unflat(a, f"gnn/{arch}/params"))
        batch = jax.tree_util.tree_map(jnp.asarray, unflat(a, f"gnn/{arch}/batch"))
        res[f"gnn/{arch}/out"] = _on(mesh, jax.jit(lambda p, b: gm.forward(p, b, cfg)),
                                     params, batch)
    lm = configs.get_spec("deepseek-moe-16b").reduced
    params = jax.tree_util.tree_map(jnp.asarray, unflat(a, "lm/params"))
    res["lm/logits"] = _on(mesh, jax.jit(lambda p, t: tm.prefill(p, t, lm)[0]), params,
                           jnp.asarray(a["lm/tokens"]))


def train_cases(a, res, mesh):
    """JAX's trainer step (``repro.launch.train.main``'s ``step_fn``, its
    placements) for two steps of the reduced gat-cora, deepseek-moe,
    h2o-danube and AutoInt."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.dist import sharding as shd
    from repro.models.gnn import models as gm
    from repro.models.recsys import autoint
    from repro.models.transformer import model as tm
    from repro.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule

    oc = AdamWConfig(lr=TRAIN_LR)
    for case in TRAIN_ARCHS:
        arch, rows = train_case(case)
        if arch == "gat-cora":
            cfg, family = gnn_cfg(arch), "gnn"
            params = unflat(a, f"gnn/{arch}/params")
            batches = [unflat(a, f"gnn/{arch}/batch")] * TRAIN_STEPS
            loss_fn = functools.partial(lambda p, b, cfg: gm.loss_fn(p, b, cfg), cfg=cfg)
        else:
            cfg = configs.get_spec(arch).reduced
            family = "recsys" if arch == "autoint" else "lm"
            params = unflat(a, train_params_key(arch))
            batches = [{k: v[:rows] for k, v in unflat(a, f"train/{arch}/batch{i}").items()}
                       for i in range(TRAIN_STEPS)]
            model_loss = autoint.loss_fn if family == "recsys" else tm.loss_fn
            loss_fn = functools.partial(lambda p, b, cfg, f: f(p, b, cfg), cfg=cfg,
                                        f=model_loss)
        params = jax.tree_util.tree_map(jnp.asarray, params)
        state = {"params": params, "opt": adamw_init(params, oc)}
        shd.activate(mesh)
        try:
            pshard = shd.param_shardings(family, params, mesh)
            state_shard = {"params": pshard, "opt": {
                "m": pshard, "v": pshard, "step": shd.replicated(jnp.zeros(()), mesh)}}
            bshard = shd.batch_shardings(family, batches[0], mesh)

            @functools.partial(jax.jit, in_shardings=(state_shard, bshard),
                               out_shardings=(state_shard, None))
            def step_fn(state, batch):
                p, o = state["params"], state["opt"]
                loss, g = jax.value_and_grad(loss_fn)(p, batch)
                lr_scale = cosine_schedule(o["step"], warmup=TRAIN_WARMUP, total=TRAIN_STEPS)
                p, o = adamw_update(g, o, p, oc, lr_scale=lr_scale)
                return {"params": p, "opt": o}, {"loss": loss}

            losses = []
            with mesh:
                for b in batches:
                    state, metrics = step_fn(state, jax.tree_util.tree_map(jnp.asarray, b))
                    losses.append(float(metrics["loss"]))
        finally:
            shd.deactivate()
        res[f"train/{case}/losses"] = np.asarray(losses, np.float32)
        res.update(flat(jax.device_get(state["params"]), f"train/{case}/params"))
        res.update(flat(jax.device_get(state["opt"]["m"]), f"train/{case}/m"))


def main(out_dir):
    a = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    res = {}
    mp_cases(a, res, _mesh((2, 2)))
    layer_cases(a, res, _mesh((2, 2)))
    moe_cases(a, res, _mesh((2, 2)))
    model_cases(a, res, _mesh((2, 2)))
    train_cases(a, res, _mesh((4, 1)))
    np.savez(os.path.join(out_dir, "jax.npz"), **{k: np.asarray(v) for k, v in res.items()})
    print("REFERENCE_OK")


if __name__ == "__main__":
    main(sys.argv[1])
