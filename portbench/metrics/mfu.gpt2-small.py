"""The GPT-2 step's model operations in the window (portbench/flops.py:
3 x the forward's products, causal attention over the keys each token
sees) over the cards' bf16 peak, %."""

from portbench.readers import mfu as read  # noqa: F401
