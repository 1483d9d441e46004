from .module import (
    Module,
    ParamSpec,
    Stacked,
    param_count,
    cast_tree,
    from_jax,
    zeros_init,
    ones_init,
    normal_init,
    lecun_init,
    conv_init,
)
from .norm import GroupNorm2D, InstanceNorm2D, LayerNorm, RMSNorm
from .conv import (
    Conv2D,
    ConvTranspose2D,
    Crop2D,
    BatchNorm2D,
    max_pool,
    avg_pool,
    leaky_relu,
)
from .linear import Linear, MultiLinear, OutputLinear
from .embed import Embedding
from .rotary import apply_mrope, apply_rope, rope_freqs
from .mlp import MLP
from .attention import Attention, MLAAttention, causal_window_mask, effective_chunk
from .moe import MoE
from .ssm import Mamba2Block, segsum, ssd_chunked, ssd_decode_step
