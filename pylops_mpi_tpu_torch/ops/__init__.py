"""Operators of the port: local blocks, the block-diagonal operator and
the normal-product kernel."""
