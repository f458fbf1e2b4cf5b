from .firefoam import FireFoamSolver, state_from_numpy, state_to_numpy
