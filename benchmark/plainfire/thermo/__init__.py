from .gas import GasThermo, RU, T_STD, P_STD
from .single_step import SingleStepReaction
