"""Model checkpoints (``checkpoint``) and mid-run grid snapshots
(``grid_state``), ports of ``repro/checkpoint``: the same file formats,
so either package reads what the other wrote."""
