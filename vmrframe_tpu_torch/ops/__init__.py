"""Tensor ops shared by the layers: masking, span inference, precision policy."""
