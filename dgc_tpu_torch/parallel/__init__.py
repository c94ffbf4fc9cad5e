"""dgc_tpu_torch.parallel — see the modules' docstrings."""
