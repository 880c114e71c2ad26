"""FedPT beyond the paper: federated fine-tuning of a modern LLM family,
on the PyTorch port.

Applies the paper's freeze-the-big-blocks recipe to a (reduced) assigned
architecture — e.g. Mixtral-style MoE, where the routed experts freeze
and only router/attention/norms train federated. On the full config this
is the dry run's train_4k step; here a reduced variant trains for real,
on the CUDA card (``--device cpu``: on the host).

    PYTHONPATH=src python examples_torch/federated_llm_finetune.py \\
        --arch mixtral-8x7b --rounds 8

``main(argv)`` returns the numbers it prints.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import load_all
from repro_torch.launch.train import run_reduced_arch


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    load_all()
    res, cfg = run_reduced_arch(args.arch, args.rounds, log=True, device=dev)
    first, last = res.history[0]["loss"], res.history[-1]["loss"]
    share = 100 * res.comm.trainable_bytes / res.comm.full_bytes
    print(f"\narch={cfg.name} (reduced: {cfg.num_layers}L d={cfg.d_model})")
    print(f"loss {first:.3f} -> {last:.3f} over {args.rounds} rounds")
    print(f"trainable bytes: {res.comm.trainable_bytes:,} "
          f"({share:.1f}% of model); "
          f"comm reduction {res.comm.reduction:.1f}x")
    assert last < first, "federated loss should decrease"
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model,
            "losses": [h["loss"] for h in res.history],
            "trainable_bytes": res.comm.trainable_bytes,
            "full_bytes": res.comm.full_bytes,
            "reduction": res.comm.reduction}


if __name__ == "__main__":
    main()
