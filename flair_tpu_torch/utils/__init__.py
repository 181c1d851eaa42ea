"""Weight conversion, device selection, CUDA kernel builds."""
