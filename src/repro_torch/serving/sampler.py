"""Token sampling (port of ``repro.serving.sampler``)."""
from __future__ import annotations

from typing import Optional

import torch


def sample(
    logits: torch.Tensor,  # (B, V) f32
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy (temperature 0) or temperature/top-k sampling. Returns (B,) int32.

    Greedy takes the first maximum, as ``jnp.argmax`` does. Sampling draws
    from ``generator`` (on the logits' device), so a run is reproducible from
    its seed; it cannot match ``jax.random``'s bits."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling needs a torch.Generator")
    logits = logits / temperature
    if top_k and 0 < top_k < logits.shape[-1]:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
