"""Every public name of every namespace of the JAX package resolves in the
port, or stands in the written list of exceptions below with its reason.

A namespace is each package of ``pylops_mpi_tpu`` (the top level, the
subpackages, among them ``plotting`` and the ``basicoperators``,
``signalprocessing`` and ``waveeqprocessing`` namespaces) and
``utils.decorators``. Its exports are its ``__all__`` where it has one,
else the public names its ``__init__.py`` binds (read from the source,
so that what other tests happen to import does not change the list),
together with its public submodules. A name resolves when the port's
namespace has the attribute or, for a submodule, a module of that name.

The list cannot go stale: an exception that resolves in the port, or that
the JAX package does not export, fails the test.
"""

import ast
import importlib
import importlib.util
import pkgutil
from pathlib import Path

import pytest

import pylops_mpi_tpu as J

_BANK = ("the disk bank of compiled executables and the persistent "
         "compile cache have no counterpart: a captured CUDA graph holds "
         "its process's device addresses, so it cannot be written to disk "
         "and loaded in another process")
_HLO = "reads XLA's HLO text; PyTorch compiles no HLO"

# (namespace, name) -> reason; a name of None stands for the whole
# namespace
EXCEPTIONS = {
    ("", "jaxcompat"): "shims over JAX versions; the port imports no JAX",
    ("native", None): (
        "the JAX package's CPU FFI kernels, not TPU kernels: the port's "
        "CPU path is each hand kernel's plain PyTorch version"),
    ("ops", "dft"): (
        "the TPU's real-arithmetic DFT, its workaround for a missing "
        "complex lowering: cuFFT and cuBLAS take complex tensors"),
    ("ops", "pallas_kernels"): (
        "the Pallas TPU kernels; their Hopper counterparts are "
        "csrc/normal_matvec.cu and csrc/stencil_taps.cu, bound in "
        "ops/normal_kernels.py and ops/stencil_kernels.py"),
    ("utils", "hlo"): _HLO,
    ("utils", "collective_report"): _HLO,
    ("utils", "assert_no_full_gather"): _HLO,
    ("aot", "compile_cache"): _BANK,
    ("aot", "executable"): _BANK,
    **{("aot", n): _BANK for n in (
        "SCHEMA_VERSION", "bank_dir", "load_index", "store_entry", "lookup",
        "rank_writes", "AotExecutable", "compile_count",
        "reset_compile_count", "serialize_compiled", "load_serialized",
        "maybe_aot_fused", "maybe_enable_compile_cache",
        "compile_cache_dir")},
}


def _namespaces():
    subs = sorted(m.name for m in pkgutil.iter_modules(J.__path__)
                  if m.ispkg)
    return [""] + subs + ["utils.decorators"]


def _module(pkg: str, ns: str):
    return importlib.import_module(pkg + ("." + ns if ns else ""))


def _bound_by_init(path: Path):
    """Public names a package's ``__init__.py`` binds at its top level:
    what it defines and what it imports from the package itself (a
    relative import also binds the first submodule it names)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom) and node.level:
            if node.module and node.level == 1:
                names.add(node.module.split(".")[0])
            names.update(a.asname or a.name for a in node.names
                         if a.name != "*")
    return {n for n in names if not n.startswith("_")}


def _exports(ns: str):
    mod = _module("pylops_mpi_tpu", ns)
    if not hasattr(mod, "__path__"):
        return set(mod.__all__)
    names = set(getattr(mod, "__all__", None)
                or _bound_by_init(Path(mod.__file__)))
    names.update(m.name for m in pkgutil.iter_modules(mod.__path__)
                 if not m.name.startswith("_"))
    return names


def _resolves(ns: str, name: str) -> bool:
    try:
        mod = _module("pylops_mpi_tpu_torch", ns)
    except ModuleNotFoundError:
        return False
    if hasattr(mod, name):
        return True
    return hasattr(mod, "__path__") and importlib.util.find_spec(
        f"{mod.__name__}.{name}") is not None


@pytest.mark.parametrize("ns", _namespaces())
def test_every_jax_export_resolves(ns):
    if (ns, None) in EXCEPTIONS:
        with pytest.raises(ModuleNotFoundError):
            _module("pylops_mpi_tpu_torch", ns)
        return
    missing = sorted(n for n in _exports(ns)
                     if (ns, n) not in EXCEPTIONS
                     and (f"{ns}.{n}".lstrip("."), None) not in EXCEPTIONS
                     and not _resolves(ns, n))
    assert not missing, f"{ns or '<top>'}: no port counterpart of {missing}"


def test_exceptions_are_jax_exports_the_port_lacks():
    for (ns, name), why in EXCEPTIONS.items():
        assert why
        if name is None:
            assert ns in _namespaces()
            continue
        assert name in _exports(ns), (ns, name)
        assert not _resolves(ns, name), f"{ns}.{name} now resolves: " \
                                        "drop its exception"


def test_renamed_counterparts():
    """Names whose counterpart has another name: aliases, or a refusal
    naming the counterpart."""
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.aot import store
    from pylops_mpi_tpu_torch.diagnostics import costmodel
    assert pmtt.clear_fused_cache is store.clear_memory
    assert pmtt.solvers.clear_fused_cache is store.clear_memory
    assert pmtt.diagnostics.peak_ici_gbps is costmodel.peak_nvlink_gbps
    g = pmtt.make_mesh_2d()
    assert g.shape == (1, 1) and g.axis_names == ("r", "c")
    with pytest.raises(ValueError, match="make_grid_2d"):
        pmtt.make_mesh_2d(4)
    with pytest.raises(NotImplementedError, match="parallel.init"):
        pmtt.initialize_multihost()
    before = pmtt.default_device()
    try:
        pmtt.set_default_mesh(pmtt.parallel.make_mesh("cpu"))
        assert pmtt.default_device().type == "cpu"
        pmtt.set_default_mesh(None)
        assert pmtt.default_device().type == "cuda"
    finally:
        pmtt.set_default_device(before)
