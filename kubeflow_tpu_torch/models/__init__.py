"""Model families of the port (the transformer LM so far)."""
