"""Serving entry point, port of ``repro/launch/serve.py``: batched greedy
or sampled autoregressive decoding with KV caches (ring buffers under a
sliding window), on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \\
      --device cpu --batch 4 --steps 32
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.models import decoder_lm as dlm
from repro_torch.nn import threefry


def prefill_by_steps(params, cfg, prompt_tokens, max_len: int, device=None,
                     cross=None):
    """Step the prompt (B, P) through ``decode_step`` one position at a
    time, as the reference's ``generate`` prefills; an encoder-decoder
    attends to ``cross`` (``dlm.build_cross_cache`` of its frames) where
    given, else to ``init_cache``'s zeros, as the reference's does.
    Returns (logits of every prompt position (B, P, V), cache)."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt_tokens, device=dev)
    B, P = prompt.shape
    cache = dlm.init_cache(cfg, B, max_len, device=dev)
    if cross is not None:
        cache["cross"] = cross
    logits = []
    for t in range(P):
        step_logits, cache = dlm.decode_step(params, cfg, cache,
                                             prompt[:, t:t + 1])
        logits.append(step_logits)
    return torch.cat(logits, dim=1), cache


def generate(params, cfg, prompt_tokens, steps: int, max_len: int = 0,
             temperature: float = 0.0, seed: int = 0, device=None,
             cross=None):
    """Greedy / sampled generation. prompt_tokens: (B, P) -> (B, P +
    steps) int32, on the card unless ``device="cpu"``. With ``temperature
    > 0`` each step splits the key of ``seed`` and draws
    ``threefry.categorical`` from the last logits over the temperature,
    as the reference draws ``jax.random.categorical``. Text only: the VLM
    decodes without its prefix, and an encoder-decoder against ``cross``
    when given (else the zero cross cache), as in the reference."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt_tokens, device=dev).to(torch.int32)
    B, P = prompt.shape
    logits, cache = prefill_by_steps(params, cfg, prompt, max_len or (P + steps),
                                     dev, cross)
    out = [prompt]
    key = threefry.key(seed)
    for _ in range(steps):
        last = logits[:, -1]
        if temperature > 0:
            key, k = threefry.split(key)
            # tensor / tensor: torch's CUDA `tensor / python_scalar` is a
            # reciprocal multiply, an ulp off the reference's division
            temp = torch.full((), temperature, dtype=last.dtype,
                              device=last.device)
            tok = threefry.categorical(k, last / temp)[:, None]
        else:
            tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
        out.append(tok)
        logits, cache = dlm.decode_step(params, cfg, cache, tok)
    return torch.cat(out, dim=1)


def main(argv=None):
    from repro_torch.launch.train import reduced_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch))
    params = dlm.init_model(cfg, 0, device=dev)
    # the reference's prompt: jax.random.randint(jax.random.key(1), ...)
    prompt = threefry.randint(threefry.key(1), (args.batch, args.prompt_len),
                              0, cfg.vocab_size)
    t0 = time.time()
    seqs = generate(params, cfg, prompt, args.steps,
                    temperature=args.temperature, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"arch={cfg.name} generated {tuple(seqs.shape)} in {dt:.1f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s) on {dev}")
    print(seqs[0].cpu().numpy())


if __name__ == "__main__":
    main()
