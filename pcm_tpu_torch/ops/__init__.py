from .common import launch_counts, reference_ops, reset_launch_counts
from .flash_attention import attention_reference, flash_attention, flash_attention_fwd
from .geglu import geglu, geglu_reference
from .groupnorm import group_norm_silu, group_norm_silu_reference
