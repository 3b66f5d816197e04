"""The package's former name, kept as an alias of ``mpas_ocean``.

Importing this package, or any module under it, gives the very module
objects of ``mpas_ocean``: ``<this>.forward.driver is
mpas_ocean.forward.driver``. New code imports ``mpas_ocean``.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import mpas_ocean

_TARGET = "mpas_ocean"


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<this>.x.y`` to the already importable ``mpas_ocean.x.y``."""

    def __init__(self, prefix):
        self.prefix = prefix + "."
        self.specs = {}

    def find_spec(self, name, path=None, target=None):
        if not name.startswith(self.prefix):
            return None
        return importlib.util.spec_from_loader(name, self)

    def create_module(self, spec):
        module = importlib.import_module(
            _TARGET + "." + spec.name[len(self.prefix):])
        self.specs[module.__name__] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the shared module;
        # give it back its own
        module.__spec__ = self.specs.pop(module.__name__)

    def get_code(self, name):
        # `python -m <this>.forward.driver` runs mpas_ocean's module
        real = _TARGET + "." + name[len(self.prefix):]
        return importlib.util.find_spec(real).loader.get_code(real)


sys.meta_path.insert(0, _AliasFinder(__name__))
sys.modules[__name__] = mpas_ocean
