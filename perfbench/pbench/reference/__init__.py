"""Plain PyTorch references that decide ``correct``. They import nothing of
the program under test, of its JAX original, or of JAX."""
