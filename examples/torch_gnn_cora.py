"""Full-batch GAT training on a Cora-like graph, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_gnn_cora.py              # on the card
    PYTHONPATH=src python examples/torch_gnn_cora.py --device cpu

``examples/gnn_cora.py`` on ``repro_torch``: the gat-cora architecture at
reduced dims, trained with AdamW for 200 full-batch epochs on a synthetic
community graph (stochastic block model) whose labels are the community
ids, until the train accuracy passes 0.8. The GNN rides the Pregel
runtime's substrate — one layer is one superstep of ``gather_rows`` and
``segment_reduce``, and their backward kernels on the card.
"""

import argparse

import numpy as np
import torch

from repro_torch.graph.structure import from_edge_list, symmetrize
from repro_torch.launch.train import value_and_grad
from repro_torch.models import common
from repro_torch.models.gnn import GNNConfig, models as gm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update_

EPOCHS = 200


def community_graph(n=400, k=4, p_in=0.05, p_out=0.002, d_feat=16, seed=0, device="cuda"):
    """Stochastic block model + community-informative features (the JAX
    example's numpy draws)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    src, dst = [], []
    for i in range(n):
        for j in range(i + 1, n):
            p = p_in if labels[i] == labels[j] else p_out
            if rng.random() < p:
                src.append(i)
                dst.append(j)
    s, d, w = symmetrize(np.array(src), np.array(dst))
    g = from_edge_list(s, d, n, w, device=device)
    feats = rng.normal(size=(n, d_feat)).astype(np.float32)
    feats += np.eye(k)[labels] @ rng.normal(size=(k, d_feat)) * 1.5
    return (g, torch.from_numpy(feats.astype(np.float32)).to(g.device),
            torch.from_numpy(labels.astype(np.int32)).to(g.device))


def config(d_in: int) -> GNNConfig:
    return GNNConfig(name="gat-cora-demo", variant="gat", n_layers=2, d_hidden=8,
                     n_heads=8, d_in=d_in, n_out=4)


def train(device="cuda", params=None, epochs: int = EPOCHS, log=print):
    """Trains the demo GAT: ``{"losses", "accs", "acc"}`` (each epoch's
    loss, the train accuracy every 50 epochs, the last); ``params`` the
    JAX package's tree of numpy arrays, else random from seed 0."""
    g, x, labels = community_graph(device=device)
    cfg = config(x.shape[1])
    params = (gm.params_from_arrays(cfg, params, g.device, trainable=True) if params is not None
              else common.trainable(gm.init(cfg, seed=0, device=g.device)))
    batch = {"x": x, "src": g.src, "dst": g.dst, "emask": g.edge_mask, "labels": labels,
             "lmask": torch.ones((g.n_vertices,), dtype=torch.float32, device=g.device)}
    oc = AdamWConfig(lr=5e-3, weight_decay=0.0)
    st = adamw_init(params, oc)
    losses, accs, acc = [], [], 0.0
    for i in range(epochs):
        loss, grads = value_and_grad(lambda q, b: gm.loss_fn(q, b, cfg), params, batch)
        adamw_update_(params, grads, st, oc)
        losses.append(float(loss))
        if (i + 1) % 50 == 0:
            with torch.no_grad():
                logits = gm.forward(params, batch, cfg)
            acc = float((logits.argmax(-1) == labels).float().mean())
            accs.append(acc)
            log(f"epoch {i+1:3d}  loss {losses[-1]:.4f}  acc {acc:.3f}")
    assert acc > 0.8, "GAT failed to learn the communities"
    return {"losses": losses, "accs": accs, "acc": acc}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = train(args.device)
    print("learned the community structure ✓")
    return res


if __name__ == "__main__":
    main()
