"""Primitives: embeddings, norms, resizes, warps, the DCT and JPEG codec,
and the two ops with CUDA kernels: the deformable conv
(``csrc/dcn_raw.cu``, ``ops.dcn``) and flash attention
(``csrc/flash_attn.cu``, ``ops.attention``). Layout: channels-last views of
NCHW channels_last activations."""
