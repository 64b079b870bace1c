"""Pallas kernels for the GPU, all on the Triton route (``backend="triton"``)."""
