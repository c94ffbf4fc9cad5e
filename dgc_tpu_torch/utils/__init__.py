"""Small host-side helpers (pytree naming, config nodes, devices)."""
