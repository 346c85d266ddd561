from .losses import cfg_combine, consistency_loss, huber_loss, l2_loss
from .schedule import DDPMSchedule, make_ddpm_schedule
from .solver import PhasedDDIMSolver, boundary_scalings, phase_boundaries, solver_grid
