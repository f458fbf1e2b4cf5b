"""The tests of tests/test_torch_wall_fire.py on the baffled wall fire
(write_wall_fire_case(baffle=True): a ceiling baffle made by createBaffles,
compressible::thermalBaffle1D<hConstSolidThermoPhysics> on T and
compressible::alphatWallFunction on alphat on both of its sides), with the
same tolerances. A file of its own so that the two JAX runs go to two
workers."""

import pytest

from test_torch_wall_fire import (  # noqa: F401  (collected here too)
    run_both,
    test_five_chained_steps,
    test_initial_state_matches,
    test_one_step_from_the_same_state,
    test_the_case_runs_the_variants_it_names,
)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_both(True, tmp_path_factory)
