from .npz import load_npz, load_optimizer_state, load_params

__all__ = ["load_npz", "load_params", "load_optimizer_state"]
