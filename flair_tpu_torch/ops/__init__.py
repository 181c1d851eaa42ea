"""Primitives: embeddings, norms, resizes, warps, attention, and the
deformable conv whose CUDA kernel is ``csrc/dcn_raw.cu`` (``ops.dcn``).
Layout: channels-last views of NCHW channels_last activations."""
