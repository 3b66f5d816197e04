"""The package's former name stays importable as an alias of mpas_ocean."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the one package at the root besides mpas_ocean itself
FORMER = next(p.parent.name for p in ROOT.glob("mpas_ocean_*/__init__.py"))


IMPORTS = textwrap.dedent(
    f"""
    import importlib
    import mpas_ocean
    import mpas_ocean.forward.driver as driver
    import mpas_ocean.structured.model as model
    old = importlib.import_module("{FORMER}")
    old_driver = importlib.import_module("{FORMER}.forward.driver")
    old_model = importlib.import_module("{FORMER}.structured.model")
    assert old is mpas_ocean
    assert old_driver is driver
    assert old_model.StructuredModel is model.StructuredModel
    assert driver.__spec__.name == "mpas_ocean.forward.driver"
    importlib.reload(driver)
    try:
        importlib.import_module("{FORMER}.no_such_module")
    except ModuleNotFoundError:
        print("ok")
    """
)


@pytest.mark.parametrize(
    "argv,rc,expect",
    [
        (["-c", IMPORTS], 0, "ok"),
        # the driver answers --help with its usage line and exit code 1
        (["-m", f"{FORMER}.forward.driver", "--help"], 1,
         "usage: python -m mpas_ocean.forward.driver"),
    ],
    ids=["same-modules", "run-driver-module"],
)
def test_former_name_is_an_alias(argv, rc, expect):
    """Old imports resolve to the very module objects of mpas_ocean (whose
    own specs stay in place), and `python -m` under the old name runs the
    driver."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, *argv], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == rc, r.stderr[-2000:]
    assert expect in r.stdout
