from .convnets import NIN, VGG16, AlexNet, GoogLeNet
from .mlp import MLP, Classifier
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18,
                     ResNet50, ResNet101)
from .transformer import MultiHeadAttention, TransformerBlock, TransformerLM

__all__ = ["MLP", "Classifier", "AlexNet", "NIN", "VGG16", "GoogLeNet",
           "ResNet", "ResNet18", "ResNet50", "ResNet101", "BottleneckBlock", "BasicBlock",
           "MultiHeadAttention", "TransformerBlock", "TransformerLM"]
