from .npz import (DictionarySerializer, NpzDeserializer, Serializer,
                  load_npz, load_optimizer_state, load_params, save_npz)

__all__ = ["Serializer", "DictionarySerializer", "NpzDeserializer",
           "save_npz", "load_npz", "load_params", "load_optimizer_state"]
