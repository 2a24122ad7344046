from . import functions, initializers, links

__all__ = ["functions", "initializers", "links"]
