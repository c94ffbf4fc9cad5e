"""dgc_tpu_torch.data — see the modules' docstrings."""
