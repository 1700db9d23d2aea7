"""Operators of the port: local operators, the block-diagonal and
stacked operators, the derivative family, and the wrappers of the
hand-written kernels (normal product, tap stencil)."""
