"""dgc_tpu_torch.telemetry — see the modules' docstrings."""
