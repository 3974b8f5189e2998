from .attention import causal_mask, mha_attention
from .decode_attention import decode_step_attention, decode_step_attention_ref
