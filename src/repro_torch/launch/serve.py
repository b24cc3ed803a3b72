"""Batched serving entry point: prefill + greedy decode on a model config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --batch 4 --prompt-len 6144 --decode-steps 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \
        --batch 4 --prompt-len 6144 --decode-steps 32          # MoE, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

The JAX package's ``repro.launch.serve`` on the port: prefill of random
prompts (last-position logits) with the ring-buffer KV cache sized for
prompt + decode, then one ``decode_step_`` per token. The parameters are
random, from ``--seed``. ``--temperature 0`` decodes greedily; above 0 it
samples from a ``torch.Generator`` (not JAX's bits). Runs on
``--device cuda`` unless told otherwise. Every LM id of the registry
serves, the MoE ones (deepseek-moe-16b: 16.9 B parameters, 33.8 GB in
bf16, on one 80 GB card) included.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch import configs
from repro_torch.graph.structure import resolve_device
from repro_torch.models.transformer import model as tm


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor  # int32 [B, 1 + decode_steps]: the prefill's token, then each step's
    logits: List[torch.Tensor]  # [B, V] per emitted token (prefill's first)
    capacity: int
    prefill_s: float
    decode_s: float


def lm_config(arch: str, reduced: bool = False):
    spec = configs.get_spec(arch)
    if spec.family != "lm":
        raise SystemExit(f"{arch} is not an LM architecture")
    return spec.reduced if reduced else spec.config


def random_prompts(cfg, batch: int, prompt_len: int, seed: int, device="cuda"):
    """int32 ``[batch, prompt_len]`` token ids, uniform over the vocabulary."""
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen)
    return toks.to(torch.int32).to(resolve_device(device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(params, cfg, prompts: torch.Tensor, decode_steps: int,
          temperature: float = 0.0, seed: int = 0) -> ServeResult:
    """Prefill ``prompts``, then ``decode_steps`` decode steps, each fed the
    previous token. Times are host-clock, each ending in a synchronise."""
    device = prompts.device
    capacity = tm.cache_len(cfg, prompts.shape[1] + decode_steps)
    gen = torch.Generator(device=device).manual_seed(seed)

    def sample(logits):
        if temperature <= 0:
            return logits.argmax(-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = tm.prefill(params, prompts, cfg, capacity=capacity, full_logits=False)
    cur = sample(logits)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0
    out, all_logits = [cur], [logits]
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        logits = tm.decode_step_(params, cache, cur, cfg)
        cur = sample(logits)[:, None]
        out.append(cur)
        all_logits.append(logits)
    _sync(device)
    return ServeResult(torch.cat(out, dim=1), all_logits, capacity,
                       prefill_s, time.perf_counter() - t0)


def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = lm_config(args.arch, args.reduced)
    params = tm.init(cfg, seed=args.seed, device=args.device)
    prompts = random_prompts(cfg, args.batch, args.prompt_len, args.seed + 1, args.device)
    res = serve(params, cfg, prompts, args.decode_steps, args.temperature, args.seed + 2)
    n_prompt = args.batch * args.prompt_len
    print(f"prefill {args.batch}×{args.prompt_len}: {res.prefill_s*1e3:.1f} ms "
          f"({n_prompt / res.prefill_s:,.0f} tok/s), cache capacity {res.capacity}")
    n_dec = args.batch * args.decode_steps
    print(f"decode {args.decode_steps} steps: {res.decode_s*1e3:.1f} ms "
          f"({n_dec / max(res.decode_s, 1e-9):,.0f} tok/s)")
    print("first stream:", res.tokens[0, :24].tolist())
    return res


if __name__ == "__main__":
    main()
