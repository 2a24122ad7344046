from .npz import load_npz, load_params

__all__ = ["load_npz", "load_params"]
