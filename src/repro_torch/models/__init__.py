"""Dense decoder-only LM of the port: layers, blocks, lm, registry."""
