"""Model configurations of the port (its own copies of the values)."""
