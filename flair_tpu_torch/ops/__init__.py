"""Primitives: embeddings, norms, resizes (MATLAB's imresize in
``ops.matlab_resize``), warps (flow and affine), the Gaussian blur, the DCT,
the JPEG and uniform quantization codecs, EMA, patch tiling, pixel
shuffle, and the two ops
with CUDA kernels: the deformable conv (``csrc/dcn_raw.cu``, ``ops.dcn``)
and flash attention (``csrc/flash_attn.cu``, ``ops.attention``). Layout:
channels-last views of NCHW channels_last activations."""

# as the JAX package's: ``dct`` / ``idct`` / ``dct_3d`` stay in ``ops.dct``
# (a function named ``dct`` here would hide that module)
from .dct import (block_dct8, block_idct8, dct1, dct_2d, dct_matrix, idct1,
                  idct_2d)
from .jpeg import (jpeg_decode, jpeg_encode, quantization_decode,
                   quantization_encode, quantization_matrix, rgb_to_ycbcr,
                   ycbcr_to_rgb)
from .shuffle import pixel_shuffle, pixel_unshuffle
