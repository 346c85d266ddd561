from .layers import NO_LORA, LoRAConv, LoRALinear, LoRASpec, attach_lora, init_lora
