"""Environment knobs and the adjoint test."""
