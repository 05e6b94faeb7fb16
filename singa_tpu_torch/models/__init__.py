"""Model zoo of the port (the transformer LM in this slice)."""
