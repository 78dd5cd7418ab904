"""Model substrate of the port: ``config`` (the shape dataclass),
``layers`` (norms, RoPE, flash attention, MLPs, embedding, chunked CE) and
``model`` (init, forward, loss and decode of all six families), with
``moe`` and ``mamba`` (the MoE and state-space blocks)."""
