from .schedule import DDPMSchedule, make_ddpm_schedule
