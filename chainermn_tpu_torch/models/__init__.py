from .mlp import MLP, Classifier
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18,
                     ResNet50, ResNet101)
from .transformer import MultiHeadAttention, TransformerBlock, TransformerLM

__all__ = ["MLP", "Classifier", "ResNet", "ResNet18", "ResNet50",
           "ResNet101", "BottleneckBlock", "BasicBlock",
           "MultiHeadAttention", "TransformerBlock", "TransformerLM"]
