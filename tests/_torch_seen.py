"""What a meshed step's layers compute on: :class:`FrozenSeen` records the
element counts of the parameter leaves that ``models/decoder_lm``'s
``train_loss`` and ``forward`` receive, on every thread, so a check can
hold them to a rank's pieces under the sharding rules (a step that made a
leaf whole before its layers ran would show the whole count). A test
helper, outside the package: the tensor-parallel tests, the dry run's
test (its subprocess has this directory on ``PYTHONPATH``) and
``chip_smoke.py``'s mesh legs (which put this directory on ``sys.path``)
import it as ``_torch_seen``."""
from __future__ import annotations

from repro_torch.nn import basic


class FrozenSeen:
    """Inside a ``with``, records the element counts of the leaves at
    ``paths`` that the decoder LM's ``train_loss`` and ``forward`` receive
    (``seen``: path -> the set of counts), from every thread: what the
    step's layers compute on, as against what the caller placed."""

    NAMES = ("train_loss", "forward")

    def __init__(self, paths):
        self.paths = set(paths)
        self.seen = {}

    def __enter__(self):
        from repro_torch.models import decoder_lm as dlm
        self.mod = dlm
        self.real = {n: getattr(dlm, n) for n in self.NAMES}
        for n, fn in self.real.items():
            setattr(dlm, n, self._spy(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.mod, n, fn)
        return False

    def _spy(self, fn):
        def spy(params, *args, **kw):
            for p, v in basic.flatten_params(params):
                if p in self.paths:
                    self.seen.setdefault(p, set()).add(v.numel())
            return fn(params, *args, **kw)
        return spy
