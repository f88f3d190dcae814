"""Model stack of the port (counterpart of ``repro.models``): the config
dataclasses, norms and RoPE, gated MLPs, grouped-query attention with its
KV cache, token-choice MoE, the layer stack and the serving steps.

Import the modules directly (``repro_torch.models.transformer``).
"""
