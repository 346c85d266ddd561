from .common import launch_counts, reference_ops, reset_launch_counts
from .flash_attention import (FlashAttentionFn, attention_bwd_reference, attention_reference,
                              flash_attention, flash_attention_bwd, flash_attention_fwd)
from .geglu import GEGLUFn, geglu, geglu_reference
from .groupnorm import GroupNormSiLUFn, group_norm_silu, group_norm_silu_reference
