"""A nested config node with attribute access (the part of
``dgc_tpu/utils/config.py`` the port's recipe needs)."""

__all__ = ["Config"]


class Config(dict):
    """``dict`` whose keys read and write as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value
