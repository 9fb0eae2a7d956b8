"""The smoke serve: the traffic and engine that ``chip_smoke.py`` serves on
the card and ``repro_torch.launch.profile`` traces, defined once so both
serve the same thing."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.request import Request, SLOSpec
from repro_torch.serving.engine import EngineConfig


def smoke_requests(vocab_size: int, seed: int = 0):
    """8 requests: a long-tail mix of prompts of 64-1536 tokens (order
    shuffled by ``seed``), 32 output tokens each, arrivals 50 ms apart,
    SLOs of TTFT 2 s and TPOT 0.1 s (placeholders: no limits are chosen
    yet)."""
    rng = np.random.default_rng(seed)
    lens = rng.permutation([64, 96, 160, 256, 384, 640, 1024, 1536])
    return [
        (Request(rid=i, arrival=0.05 * i, input_len=int(m), output_len=32,
                 slo=SLOSpec(ttft=2.0, tpot=0.1)),
         list(map(int, rng.integers(2, vocab_size, int(m)))))
        for i, m in enumerate(lens)
    ]


def smoke_engine_config(page_size: Optional[int] = None) -> EngineConfig:
    """8 decode lanes of 2048 tokens, 512-token prefill chunks, the Kairos
    policies, no end-of-sequence token (every request generates exactly its
    output length)."""
    return EngineConfig(max_slots=8, max_len=2048, chunk_size=512,
                        prefill_policy="kairos-urgency", decode_policy="kairos-slack",
                        eos_token=-1, page_size=page_size)
