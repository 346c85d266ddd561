from .ddim import DDIMSampler, trailing_timesteps
from .pipeline import TextToImagePipeline
