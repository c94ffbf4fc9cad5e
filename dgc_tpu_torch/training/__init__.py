"""dgc_tpu_torch.training — see the modules' docstrings."""
