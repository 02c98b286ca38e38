"""Model zoo exports (the TPU package's models/__init__.py surface;
`unet_forward_with_features` is ``UNet3D.forward(x, return_features=True)``
here)."""

from .daft import DAFTBlock, DAFTResNet
from .densenet import DilatedDenseNet, densenet_2d, densenet_3d
from .hypergraph import MSHyperModel, hypergraph_conv
from .resnet3d import (ResNet3D, generate_model, image_encoder, resnet10, resnet18,
                       resnet34, resnet50, resnet101, resnet152, resnet200)
from .transformer import (SFCN, CrossTransformer, CrossTransformerModAvg,
                          MultimodalClassifier, SmallCNN3D, Transformer)
from .unet3d import UNet3D, UNet3DClassifier

__all__ = [
    "ResNet3D", "generate_model", "image_encoder", "resnet10", "resnet18",
    "resnet34", "resnet50", "resnet101", "resnet152", "resnet200",
    "UNet3D", "UNet3DClassifier",
    "DilatedDenseNet", "densenet_2d", "densenet_3d",
    "MSHyperModel", "hypergraph_conv", "DAFTBlock", "DAFTResNet",
    "SFCN", "SmallCNN3D", "Transformer", "CrossTransformer",
    "CrossTransformerModAvg", "MultimodalClassifier",
]
