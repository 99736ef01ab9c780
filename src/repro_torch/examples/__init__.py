"""Twins of the repository's ``examples/`` scripts, run as
``python -m repro_torch.examples.<name>`` (on the card unless given
``--device cpu``); each prints ``OK`` at its end."""
