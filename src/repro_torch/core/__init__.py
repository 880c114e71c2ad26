"""FedPT core, port of ``repro/core``: parameter partitioning, seed
reconstruction, the federated round engine, DP mechanisms and
communication accounting.

Function names that would shadow their submodule (``partition``,
``reconstruct``) are exported with ``_params`` / ``_frozen`` suffixes, as
in the reference; the submodules stay importable as
``repro_torch.core.partition`` and so on.
"""
from repro_torch.core.partition import (partition as partition_params,
                                        merge, summarize, summarize_plan,
                                        partition_plan, trainable_fraction)
from repro_torch.core.reconstruct import (reconstruct as reconstruct_frozen,
                                          make_reconstructor,
                                          init_partitioned, verify_roundtrip)
from repro_torch.core.fedpt import (RoundConfig, make_round_fn,
                                    make_client_update, clip_delta,
                                    make_eval_fn)
from repro_torch.core.flat import FlatLayout
from repro_torch.core.plan import TrainPlan, Tier, CompiledPlan, compile_plan
from repro_torch.core.dp import (DPFTRLConfig, dp_ftrl_server_opt, tree_noise,
                                 NOISE_TO_EPS)
from repro_torch.core.comm import CommReport, report_for

# restore submodule attributes clobbered by the re-exports above
from repro_torch.core import (partition, reconstruct, fedpt, dp,  # noqa: E402,F811
                              comm, flat, plan)
