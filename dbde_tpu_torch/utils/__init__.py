"""Host helpers: frame visualization (numpy) and device timing (CUDA)."""
