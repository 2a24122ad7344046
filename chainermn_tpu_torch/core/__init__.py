from .link import Chain, ChainList, Link

__all__ = ["Link", "Chain", "ChainList"]
