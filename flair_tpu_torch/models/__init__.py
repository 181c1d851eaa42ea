"""BicubicUNet, BlurUNet, SPyNet, BasicVSR++ and their blocks (torch.nn)."""

from .registry import get_model, list_models, register_model
