"""The sprinkler fire step without the spray's terms in fvDOM (the cloud's
`radiation off`; fvDOM still solves the gas's radiation): the port's
FireFoamSolver against the JAX package's on CPU in float64, with the tests
and tolerances of tests/test_torch_spray_step.py (initial state, one step
from the same state at steps 1, 6 and 11, 5 chained steps after 10 warm-up
steps, the checkpoint across the two packages, the mass bookkeeping)."""

import pytest

import test_torch_spray_step as base
from test_torch_spray_step import (  # noqa: F401  (the shared tests)
    test_checkpoint_resumes_across_packages, test_five_chained_steps,
    test_initial_state_matches, test_mass_bookkeeping_closes, test_step_from_the_same_state)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return base.trajectory(tmp_path_factory.mktemp("spray_norad"), False)


@pytest.fixture(autouse=True)
def _no_spray_radiation(monkeypatch):
    monkeypatch.setattr(base, "RADIATION", False)
