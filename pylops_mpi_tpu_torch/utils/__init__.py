"""Environment knobs, the adjoint test, the distributed fftshifts and
the checkpoints.

``fftshift_nd``/``ifftshift_nd`` load on first access: their module
imports the array module, which is still loading when the package
imports ``utils.deps``."""

from importlib import import_module

_EXPORTS = {"fftshift_nd": "fft_helper", "ifftshift_nd": "fft_helper",
            **{n: "checkpoint" for n in (
                "save_solver", "load_solver", "save_pytree", "load_pytree",
                "save_fused_carry", "load_fused_carry")}}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
