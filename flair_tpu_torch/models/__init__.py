"""BicubicUNet, BlurUNet, SPyNet, BasicVSR++ and their blocks, and the face
models CodeFormer and ParseNet (torch.nn)."""

from .registry import get_model, list_models, register_model
