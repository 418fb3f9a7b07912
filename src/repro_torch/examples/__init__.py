"""The repo's five examples over the port's API, each run as ``python -m
repro_torch.examples.<name>``: ``quickstart``, ``serve_isrtf``,
``simulate_cluster``, ``train_lm`` and ``train_predictor``.  Each takes
the flags of the script of the same name in ``examples/`` and prints its
lines.  All but ``simulate_cluster`` (host code) take ``--device``, the
card by default; without a card and without ``--device cpu`` they exit
with the reason (``device.device_or_exit``)."""
