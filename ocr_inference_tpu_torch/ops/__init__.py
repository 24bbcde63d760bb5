"""Image ops on tensors, tiling, packing and the kernel wrappers."""
