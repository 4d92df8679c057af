"""PNN models (PointNet++, PointNeXt, PointVector) in PyTorch."""
