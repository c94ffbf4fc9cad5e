"""dgc_tpu_torch.optim — see the modules' docstrings."""
