"""The ``examples_torch/`` twins of the reference's six examples: their
flags, and the quickstart's and ``dp_federated_lm``'s printed numbers
against the reference example's (``tests/_torch_examples.py`` runs both
in this process, the twin with ``--device cpu``).

Tolerances (absolute, on the printed values; every other number must be
equal as printed). The port's round is the reference's to float32
rounding: fed the reference's ``y`` each round, the quickstart's losses
agree within 5e-7 and ``y`` within 2e-7 (measured). Run freely, the two
trajectories drift apart as SGD amplifies those roundings, about
twofold a round from the fourth on, and the drift depends on how many
threads torch sums with: the quickstart's 10th loss and its test
accuracy have differed by up to 8e-3 (both measured on this host's CPU),
so they are held within 1e-2. ``dp_federated_lm``'s clipped, DP-FTRL
rounds drift less (2e-4 over 20 rounds, measured): 2e-3.
``dp_federated_lm`` runs 2 rounds here (the CI runs it nowhere; its
default 20 run on the card in ``chip_smoke.py``).
"""
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)

import _torch_examples as ex

QUICKSTART_TOL = 1e-2
DP_TOL = 2e-3
DP_ROUNDS = ["--rounds", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ex.NAMES)
def test_twin_takes_every_reference_flag_with_its_default(name):
    """Each twin's parser takes every flag of the reference's with the
    same default, type and action, plus ``--device`` defaulting to the
    card."""
    actions = {a.option_strings[0]: a
               for a in ex.load_twin(name).parser()._actions
               if a.option_strings and a.dest != "help"}
    want = ex.reference_flags(name)
    assert set(actions) == set(want) | {"--device"}
    assert actions["--device"].default == "cuda"
    for flag, kw in want.items():
        got = actions[flag]
        assert got.default == kw.get("default",
                                     False if kw.get("action") else None)
        if "type" in kw:
            assert got.type.__name__ == kw["type"]
        if kw.get("action") == "store_true":
            assert got.const is True and got.nargs == 0


def test_quickstart_prints_the_references_numbers(tmp_path, monkeypatch):
    ref, _ = ex.run_reference("quickstart", [], tmp_path / "ref",
                              monkeypatch)
    twin, res = ex.run_twin("quickstart", [], tmp_path / "twin", monkeypatch)
    ex.compare(ref, twin, fuzzy=(r"client loss (\d+\.\d+)",
                                 r"after 10 rounds: (\d+\.\d+)"),
               tol=QUICKSTART_TOL)
    assert len(res["losses"]) == 10 and res["losses"][-1] < res["losses"][0]
    assert res["accuracy"] > 1 / 62


def test_dp_federated_lm_prints_the_references_numbers(tmp_path,
                                                       monkeypatch):
    ref, _ = ex.run_reference("dp_federated_lm", DP_ROUNDS, tmp_path / "ref",
                              monkeypatch)
    twin, res = ex.run_twin("dp_federated_lm", DP_ROUNDS, tmp_path / "twin",
                            monkeypatch)
    ex.compare(ref, twin, fuzzy=(r"loss=(\d+\.\d+)", r"acc=(\d+\.\d+)"),
               tol=DP_TOL)
    assert len(res["losses"]) == 2
