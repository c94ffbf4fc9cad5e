"""dgc_tpu_torch.models — see the modules' docstrings."""
