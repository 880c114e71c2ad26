"""Differentially-private FedPT on the Stack Overflow NWP transformer —
the paper's §4.2 experiment: DP-FTRL server with per-client clipping, on
the partially trainable model (FFN hidden layers of all 3 encoder blocks
frozen, 73.8% trainable), on the PyTorch port. The rounds run on the
CUDA card; ``--device cpu`` runs the kernels' plain versions.

    PYTHONPATH=src python examples_torch/dp_federated_lm.py [--noise 2.33]

``main(argv)`` returns the numbers it prints.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.core import dp, fedpt
from repro_torch.data import synthetic as syn
from repro_torch.fl import runtime
from repro_torch.models import decoder_lm as dlm
from repro_torch.models import paper_models as pm

VOCAB = 2004


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--noise", type=float, default=2.33)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--fully-trainable", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    return ap


def loss_fn(params, b):
    logits = pm.so_transformer_forward(params, b["tokens"])
    return dlm.lm_loss(logits[:, :-1], b["tokens"][:, 1:]), {}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    ds = syn.make_federated_tokens(48, 64, vocab=VOCAB, seed=0)
    spec = () if args.fully_trainable else pm.so_freeze_spec((0, 1, 2))

    # DP-FTRL server optimizer: privatized cumulative sums via tree noise
    dcfg = dp.DPFTRLConfig(lr=0.3, noise_multiplier=args.noise,
                           clip_norm=0.3, clients_per_round=16, momentum=0.9)
    sopt = dp.dp_ftrl_server_opt(dcfg)
    rc = fedpt.RoundConfig(16, 2, 16, "sgd", 10 ** -0.5, "sgd", 1.0,
                           dp_clip_norm=0.3, uniform_weights=True)

    res = runtime.run_federated(
        lambda s: pm.init_so_transformer(s, VOCAB, device=dev), loss_fn, ds,
        rc, args.rounds, freeze_spec=spec, data_kind="tokens",
        server_opt=sopt, log=True, eval_every=args.rounds,
        eval_fn=runtime.nwp_accuracy_eval(pm.so_transformer_forward,
                                          ds.test_tokens[:128]),
        device=dev)

    eps = dp.NOISE_TO_EPS.get(args.noise, "n/a")
    label = "FT" if args.fully_trainable else "PT(73.8%)"
    last = res.history[-1]
    print(f"\n{label}  noise={args.noise} (paper eps~{eps}): "
          f"acc={last.get('accuracy'):.4f} "
          f"loss={last['loss']:.3f} "
          f"comm reduction={res.comm.reduction:.2f}x")
    return {"losses": [h["loss"] for h in res.history],
            "accuracy": last.get("accuracy"),
            "reduction": res.comm.reduction,
            "trainable_bytes": res.comm.trainable_bytes}


if __name__ == "__main__":
    main()
