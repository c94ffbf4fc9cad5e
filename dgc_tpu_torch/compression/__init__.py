"""dgc_tpu_torch.compression — see the modules' docstrings."""
