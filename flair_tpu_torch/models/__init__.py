"""BicubicUNet, BlurUNet, SPyNet, BasicVSR++ and their blocks, the face
models (CodeFormer, ParseNet, RetinaFace, and the alternatives VQFR,
RestoreFormer, VQVAEGAN, BiSeNet and YOLOv5-face), and the video models
SuperSloMo, AMT and DAVSRNet (torch.nn)."""

from .registry import get_model, list_models, register_model
