"""Model substrate of the port: ``config`` (the shape dataclass),
``layers`` (norms, RoPE, flash attention, MLPs, embedding, chunked CE) and
``model`` (the dense family's init, forward and loss)."""
