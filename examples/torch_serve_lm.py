"""Batched LM serving on the PyTorch/CUDA port: prefill + decode with the
KV ring buffer.

    PYTHONPATH=src python examples/torch_serve_lm.py --batch 4 --prompt-len 64 \
        --decode-steps 32                                  # on the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

``examples/serve_lm.py`` on ``repro_torch``: a small sliding-window LM
(f32); the prefill (attention through ``kernels.flash_attention`` on the
card) fills the window-bounded KV cache, then batched greedy decode steps
(``decode_step_``, in place over the ring buffer) stream tokens; prints
prefill and decode throughput. The SWA preset keeps an O(window) cache.
"""

import argparse
import time

import torch

from repro_torch.graph.structure import resolve_device
from repro_torch.models.transformer import TransformerConfig, model as tm


def config(swa_window: int = 32) -> TransformerConfig:
    return TransformerConfig(
        name="serve-demo", n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=384, vocab_size=2048, d_head=16, swa_window=swa_window,
        param_dtype="float32", compute_dtype="float32",
        attn_chunk_q=64, attn_chunk_kv=64,
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(params, cfg, prompts: torch.Tensor, decode_steps: int):
    """Greedy prefill + ``decode_steps`` decode steps: ``{"tokens" int32
    [B, 1 + steps], "capacity", "prefill_s", "decode_s"}``."""
    dev = prompts.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = tm.prefill(params, prompts, cfg, full_logits=False)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    cur = logits.argmax(-1)[:, None].to(torch.int32)
    toks = [cur]
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        logits = tm.decode_step_(params, cache, cur, cfg)
        cur = logits.argmax(-1)[:, None].to(torch.int32)
        toks.append(cur)
    _sync(dev)
    return {"tokens": torch.cat(toks, dim=1), "capacity": cache["k"].shape[2],
            "prefill_s": t_prefill, "decode_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--swa-window", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = config(args.swa_window)
    dev = resolve_device(args.device)
    params = tm.init(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen).to(torch.int32).to(dev)
    res = serve(params, cfg, prompts, args.decode_steps)
    b, p, n = args.batch, args.prompt_len, args.decode_steps
    print(f"prefill: {b}×{p} tokens in {res['prefill_s']*1e3:.1f} ms "
          f"({b*p/res['prefill_s']:,.0f} tok/s); "
          f"KV cache len = {res['capacity']} (window-bounded)")
    print(f"decode: {n} steps × batch {b} in {res['decode_s']*1e3:.1f} ms "
          f"({b*n/max(res['decode_s'], 1e-9):,.0f} tok/s)")
    print("sampled token ids (first request):", res["tokens"][0, :16].tolist(), "...")
    return res


if __name__ == "__main__":
    main()
