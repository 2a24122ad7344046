from .convnets import NIN, VGG16, AlexNet, GoogLeNet
from .dcgan import DCGANUpdater, Discriminator, Generator
from .mlp import MLP, Classifier
from .moe_transformer import (MoEFeedForward, MoETransformerBlock,
                              MoETransformerLM)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18,
                     ResNet50, ResNet101)
from .seq2seq import (Decoder, Encoder, ModelParallelSeq2seq, Seq2seq,
                      create_model_parallel_seq2seq,
                      make_synthetic_translation_data)
from .transformer import MultiHeadAttention, TransformerBlock, TransformerLM

__all__ = ["MLP", "Classifier", "AlexNet", "NIN", "VGG16", "GoogLeNet",
           "ResNet", "ResNet18", "ResNet50", "ResNet101", "BottleneckBlock", "BasicBlock",
           "Generator", "Discriminator", "DCGANUpdater",
           "Seq2seq", "Encoder", "Decoder", "ModelParallelSeq2seq",
           "create_model_parallel_seq2seq",
           "make_synthetic_translation_data",
           "MultiHeadAttention", "TransformerBlock", "TransformerLM",
           "MoEFeedForward", "MoETransformerBlock", "MoETransformerLM"]
