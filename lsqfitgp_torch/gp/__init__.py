from ._gp import GP, DefaultProcess
