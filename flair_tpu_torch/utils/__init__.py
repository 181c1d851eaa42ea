"""Weight conversion and checkpoint loading, configs, PNG I/O, device
selection, CUDA kernel builds."""
