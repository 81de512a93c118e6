"""repro_torch.launch — entry points. ``train``: the one-card training
launcher (``python -m repro_torch.launch.train``); the torchrun launcher
and the dry-run tooling wait for ROADMAP item 23."""
