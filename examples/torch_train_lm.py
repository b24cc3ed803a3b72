"""End-to-end LM training on the PyTorch/CUDA port (``repro_torch``).

    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 200 --device cpu
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300   # on the card

``examples/train_lm.py`` on the port. Presets:
  tiny — ~2M params; a few hundred steps run in minutes on a CPU and the
          loss visibly converges on synthetic Zipf text.
  100m — ~100M-param config (d_model 640, 12 layers, GQA 4:1), for a run of
          a few hundred steps on the card. Identical code path.

Config → synthetic pipeline → AdamW + cosine schedule → the supervised
loop with async checkpoints, failure recovery and straggler monitoring
(``repro_torch.launch.train.Supervised``; ``--inject-failures`` drills the
restore-and-replay path).
"""

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.data.pipeline import token_batches
from repro_torch.launch.train import Supervised
from repro_torch.models.transformer import TransformerConfig, model as tm
from repro_torch.optim import AdamWConfig

PRESETS = {
    "tiny": TransformerConfig(
        name="tiny-lm", n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=384, vocab_size=2048, d_head=16,
        param_dtype="float32", compute_dtype="float32",
        attn_chunk_q=64, attn_chunk_kv=64,
    ),
    "100m": TransformerConfig(
        name="lm-100m", n_layers=12, d_model=640, n_heads=10, n_kv_heads=2,
        d_ff=1792, vocab_size=32000, d_head=64,
    ),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "train_lm_ckpt"))
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated step indices to fail at (drill)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    print(f"model: {cfg.name} ({cfg.n_params() / 1e6:.1f}M params)")

    params = tm.init(cfg, seed=0, device=args.device, trainable=True)
    oc = AdamWConfig(lr=args.lr, weight_decay=0.01)
    data = token_batches(args.batch, args.seq, cfg.vocab_size, seed=1, device=args.device)
    batches = [next(data) for _ in range(32)]
    t_start = time.perf_counter()

    def log(line):
        if line.startswith("step "):
            s = int(line.split()[1])
            tok_s = s * args.batch * args.seq / (time.perf_counter() - t_start)
            line = f"{line.split('(')[0]} ({tok_s:,.0f} tok/s)"
        print(line, flush=True)

    run = Supervised(
        "lm", params, lambda p, b: tm.loss_fn(p, b, cfg),
        lambda i: batches[i % len(batches)], oc,
        warmup=args.steps // 10, total=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=100, log_every=25, log=log, device=args.device,
        inject_failures=[int(x) for x in args.inject_failures.split(",") if x],
    )
    step, _ = run.run(args.steps)
    losses = [loss for _, loss in run.losses]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss: {first:.3f} → {last:.3f} over {step} steps "
          f"({'-' if last < first else '+'}{abs(first - last):.3f}); "
          f"retries={run.sup.retries} restarts={run.sup.restarts}")
    if not last < first:
        raise SystemExit("training did not reduce the loss")
    print("converging ✓")


if __name__ == "__main__":
    main()
