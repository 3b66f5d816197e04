"""Bit-stability regression gate: exact f64 CPU values pinned at rtol 1e-13
(the reference pins operator norms at atol
1e-8 on its own mesh instance, test/ocn/test_Operators.jl:52-91; this is
the same idea for the in-repo meshes plus N-step rollout checksums).

If a numerics change is INTENDED, regenerate with
`PYTHONPATH=. python tests/golden_fixtures.py` and commit the diff.
"""

import json

import pytest

from golden_fixtures import GOLDEN_PATH, compute_golden


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fresh():
    return compute_golden()


def test_golden_values_pinned(golden, fresh):
    assert set(fresh) == set(golden)
    for key, want in golden.items():
        assert fresh[key] == pytest.approx(want, rel=1e-13), key
