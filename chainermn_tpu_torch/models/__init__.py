from .transformer import MultiHeadAttention, TransformerBlock, TransformerLM

__all__ = ["MultiHeadAttention", "TransformerBlock", "TransformerLM"]
