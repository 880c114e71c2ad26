"""Serving example: autoregressive decoding with the framework's cache
machinery — ring-buffer sliding-window KV cache (Mixtral-style) and
constant-state SSM decode (xLSTM), the mechanisms behind the `long_500k`
dry-run shape — on the PyTorch port, on the CUDA card (``--device cpu``:
on the host).

    PYTHONPATH=src python examples_torch/serve_longcontext.py

``main(argv)`` returns, by architecture, the numbers it prints and the
decoded sequences.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import load_all
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import generate
from repro_torch.launch.train import reduced_config
from repro_torch.models import decoder_lm as dlm
from repro_torch.nn import basic, threefry

ARCHS = ("mixtral-8x7b", "xlstm-350m")


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    load_all()
    out = {}
    for arch in ARCHS:
        cfg = reduced_config(get_config(arch))
        if cfg.sliding_window:
            cfg = cfg.with_(sliding_window=16)  # exercise the ring buffer
        params = dlm.init_model(cfg, 0, device=dev)
        prompt = threefry.randint(threefry.key(1), (2, 8), 0, cfg.vocab_size,
                                  device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.time()
        seqs = generate(params, cfg, prompt, steps=48, max_len=64,
                        device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        cache = dlm.init_cache(cfg, 2, 64, device=dev)
        n_state = sum(x.numel() for _, x in basic.flatten_params(cache)
                      if isinstance(x, torch.Tensor))
        kind = (f"ring KV cache (window={cfg.sliding_window})"
                if cfg.sliding_window else "constant SSM state")
        print(f"{arch:14s} [{cfg.family}] decoded {seqs.shape[1]-8} "
              f"tokens/seq in {dt:.1f}s via {kind}; cache elements/seq: "
              f"{n_state//2:,}")
        out[arch] = {"family": cfg.family, "decoded": seqs.shape[1] - 8,
                     "seconds": dt, "cache_elements": n_state // 2,
                     "window": cfg.sliding_window,
                     "prompt": prompt.cpu().numpy(),
                     "tokens": seqs.cpu().numpy()}
    return out


if __name__ == "__main__":
    main()
