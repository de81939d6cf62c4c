"""The benchmark's harness: the generator of inputs (``traffic``), the
system built from a configuration file (``system``), the offline run of
one window (``drive``), the profiled slice (``profiling``), the
yardstick's arithmetic (``flops``), what readers see (``readers``), the
check against the plain reference (``check``) and one run of a cell
(``cell``)."""
import importlib.util
import sys


def load_file(path, name: str):
    """A Python file of the benchmark's, loaded by its path as the module
    ``name`` (entered in ``sys.modules``, as an import would): a metric's
    reader, a configuration's reference or FLOP count."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
