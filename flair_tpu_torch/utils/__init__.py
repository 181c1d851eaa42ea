"""Weight conversion, checkpoint loading and saving, configs, the training
logger, PNG I/O, device selection, CUDA kernel builds, host spans."""
