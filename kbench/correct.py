"""Whether what the timed path served is right: a sample of the requests
it finished, the longest among them, run through the plain reference the
configuration names (``kbench/reference/<reference>.py``, found by
``spec.reference``) once over each prompt with its served tokens.

For every served token, its logit gap: how far the reference's logit of
that token lies below the reference's best at that position. Greedy
decoding serves the argmax of the program's bf16 logits, so a sound program
only loses near-ties to rounding and the gaps stay small; a wrong cache,
position, handoff or sampler serves tokens the reference ranks far lower.
The numbers compared are the widest gap, or the mean gap over the sample
(where rounding flips a mixture's routes, the widest gap of a sound run
reads as high as the float8 control's; the mean separates them), as the
configuration file's ``correct.limits`` names; PERF.md gives the readings
each limit was set from.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, TextIO, Tuple

import numpy as np
import torch

from kbench.spec import reference


def sample(done: Dict[int, List[int]], prompts: Dict[int, List[int]], seed: int,
           tokens: int, max_requests: int) -> List[int]:
    """Finished requests to check: the longest (prompt + served), then
    others drawn from ``seed`` until ``tokens`` served tokens or
    ``max_requests`` requests."""
    rids = sorted(r for r, out in done.items() if out)
    if not rids:
        return []
    longest = max(rids, key=lambda r: (len(prompts[r]) + len(done[r]), r))
    rest = [r for r in rids if r != longest]
    order = np.random.default_rng(seed).permutation(len(rest))
    out, n = [longest], len(done[longest])
    for i in order:
        if n >= tokens or len(out) >= max_requests:
            break
        out.append(rest[i])
        n += len(done[rest[i]])
    return out


def served_rows(prompt: Sequence[int], served: Sequence[int]) -> Tuple[List[int], List[int]]:
    """The sequence the reference runs (prompt and all but the last served
    token) and the positions whose logits pick each served token."""
    seq = list(prompt) + list(served[:-1])
    return seq, list(range(len(prompt) - 1, len(prompt) - 1 + len(served)))


def gaps(logits_at: Callable, weights: Dict, cfg: Dict, seqs, rows, served,
         quant: Optional[str] = None, ref: Optional[List[torch.Tensor]] = None
         ) -> Tuple[np.ndarray, List[torch.Tensor]]:
    """Per served token, the reference's best logit minus its logit of the
    token chosen: the served token, or (``quant``) the argmax of the
    reference computed at that lower precision. ``logits_at`` is the
    reference's. Returns the gaps and the float32 reference logits (to
    reuse)."""
    if ref is None:
        ref = logits_at(weights, cfg, seqs, rows)
    if quant is None:
        picks = [torch.tensor(s, device=r.device) for s, r in zip(served, ref, strict=True)]
    else:
        low = logits_at(weights, cfg, seqs, rows, quant=quant)
        picks = [lo.argmax(-1) for lo in low]
    out = []
    for r, p in zip(ref, picks, strict=True):
        best = r.max(-1).values
        out.append((best - r.gather(1, p[:, None].long())[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0), ref


NUMBERS = {
    "widest_logit_gap": lambda g: float(g.max()),
    "mean_logit_gap": lambda g: float(g.mean()),
}


def check(weights: Dict, cfg: Dict, prompts: Dict[int, List[int]],
          done: Dict[int, List[int]], seed: int, log: TextIO,
          control: Optional[Sequence[str]] = None, root: Optional[Path] = None) -> Dict:
    """The run's verdict on the numbers the configuration's
    ``correct.limits`` names (of `NUMBERS`), against the reference it
    names (looked up under ``root``, as ``spec.reference`` does); prints
    them, with their limits, as the last lines on ``log``. ``control``
    (the control runs only) also reads, for each precision named, the gaps
    of the tokens the reference at that precision puts first, at the same
    positions."""
    logits_at = reference(cfg, root)
    c = cfg["correct"]
    limits = {k: float(v) for k, v in c["limits"].items()}
    rids = sample(done, prompts, seed, int(c["sample_tokens"]), int(c["max_requests"]))
    t = time.monotonic()
    readings = {}
    if rids:
        seqs, rows = zip(*(served_rows(prompts[r], done[r]) for r in rids))
        served = [done[r] for r in rids]
        g, ref = gaps(logits_at, weights, cfg, seqs, rows, served)
        readings["program"] = g
        for q in control or ():
            readings[q], _ = gaps(logits_at, weights, cfg, seqs, rows, served, quant=q, ref=ref)
    values = {k: NUMBERS[k](readings["program"]) if rids else None for k in limits}
    ok = bool(rids) and all(values[k] <= lim for k, lim in limits.items())
    n_tok = sum(len(done[r]) for r in rids)
    print(f"[kbench] checked {len(rids)} finished requests of {len(done)} ({n_tok} served "
          f"tokens; longest {len(prompts[rids[0]]) + len(done[rids[0]]) if rids else 0} "
          f"tokens) against the float32 reference {cfg['reference']!r} in {time.monotonic() - t:.1f} s; "
          + ", ".join(f"{k} {f(readings['program'])!r}" for k, f in NUMBERS.items() if rids),
          file=log)
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    checks["checked_requests"] = {"value": len(rids), "limit": 1}
    print("[kbench] compared: " + "; ".join(
        f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items())
        + f" -> correct={ok}", file=log)
    return dict(correct=ok, values=values, readings=readings, rids=rids, checks=checks)
