from .kEqn import KEqnLES
