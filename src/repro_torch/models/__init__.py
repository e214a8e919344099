"""Model code of the port: the decoder-only transformer family."""
