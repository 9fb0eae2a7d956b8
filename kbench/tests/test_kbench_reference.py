"""The configuration names its plain reference, and the check calls that
one: on fixed weights, prompts and served tokens its gaps are those of
``kbench.reference.model.logits_at`` called directly; a configuration that
names none, or one that is not there, fails. The reference honours the
configuration's ``attention_windows``."""
import io
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from kbench.bench import model_config
from kbench.correct import check, served_rows
from kbench.reference import model as ref_model
from kbench.spec import reference
from kbench.weights import make_weights
from repro_torch.models import build_model

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _tiny_cfg(name="minicpm-2b"):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg.update(name="tiny", num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=128,
               vocab_size=256, max_len=256, num_kv_heads=2)
    if cfg.get("num_experts"):
        cfg["num_experts"] = 4
    cfg["correct"].update(sample_tokens=10_000, max_requests=100)
    return cfg


def _weights(cfg, seed=5):
    return make_weights(build_model(model_config(cfg)).param_struct(), seed, torch.device("cpu"))


@pytest.mark.parametrize("config", ["minicpm-2b", "phi3.5-moe-16l"])
def test_the_checks_gaps_are_the_named_references(config):
    cfg = _tiny_cfg(config)
    assert cfg["reference"] == "model"
    weights = _weights(cfg)
    rng = np.random.default_rng(7)
    prompts = {r: rng.integers(2, 256, size=n).tolist() for r, n in enumerate((40, 9, 70))}
    done = {r: rng.integers(2, 256, size=n).tolist() for r, n in enumerate((12, 5, 20))}
    c = check(weights, cfg, prompts, done, seed=11, log=io.StringIO(), control=("fp8",))
    assert sorted(c["rids"]) == [0, 1, 2]
    seqs, rows = zip(*(served_rows(prompts[r], done[r]) for r in c["rids"]))
    want, want_fp8 = [], []
    ref = ref_model.logits_at(weights, cfg, seqs, rows)
    low = ref_model.logits_at(weights, cfg, seqs, rows, quant="fp8")
    for r, lg, lo in zip(c["rids"], ref, low, strict=True):
        best = lg.max(-1).values
        want.append((best - lg.gather(1, torch.tensor(done[r])[:, None])[:, 0]).numpy())
        want_fp8.append((best - lg.gather(1, lo.argmax(-1)[:, None])[:, 0]).numpy())
    np.testing.assert_array_equal(c["readings"]["program"], np.concatenate(want))
    np.testing.assert_array_equal(c["readings"]["fp8"], np.concatenate(want_fp8))


@pytest.mark.parametrize("name,said", [(None, "names no reference"),
                                       ("llama", "names the reference 'llama'"),
                                       ("../reference/model", "names the reference"),
                                       ("__init__", "names the reference '__init__'")])
def test_a_configuration_without_its_reference_fails_loudly(name, said):
    cfg = _tiny_cfg()
    cfg.pop("reference")
    if name is not None:
        cfg["reference"] = name
    with pytest.raises(ValueError, match=f"configuration 'tiny' {said}"):
        reference(cfg)
    with pytest.raises(ValueError, match="configuration 'tiny'"):
        check({}, cfg, {}, {}, seed=1, log=io.StringIO())


def test_the_program_gets_neither_key():
    cfg = dict(_tiny_cfg(), attention_windows=[4, 0])
    mc = model_config(cfg)
    assert not hasattr(mc, "reference") and not hasattr(mc, "attention_windows")
    assert mc.sliding_window == 0


def _naive(q, k, v, window):
    s, hq, d = q.shape
    kk = k.repeat_interleave(hq // k.shape[1], dim=1)
    vv = v.repeat_interleave(hq // k.shape[1], dim=1)
    sc = torch.einsum("qhd,khd->hqk", q, kk) / math.sqrt(d)
    qp, kp = torch.arange(s)[:, None], torch.arange(s)[None, :]
    seen = (kp <= qp) & ((qp - kp < window) if window else True)
    p = torch.softmax(sc.masked_fill(~seen[None], float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, vv)


@pytest.mark.parametrize("window", [0, 1, 5, 16, 37, 300])
@pytest.mark.parametrize("block", [8, 64])
def test_windowed_attention_sees_only_its_window(window, block):
    g = torch.Generator().manual_seed(window * 100 + block)
    q, k, v = (torch.randn(70, h, 8, generator=g) for h in (4, 2, 2))
    got = ref_model._attention(q, k, v, block, window)
    torch.testing.assert_close(got, _naive(q, k, v, window), rtol=1e-5, atol=1e-6)
    if window >= 70:  # a window wider than the sequence does not bind
        assert torch.equal(got, ref_model._attention(q, k, v, block))


def test_windows_of_zero_are_no_windows_and_a_window_that_binds_changes_the_logits():
    cfg = _tiny_cfg()
    weights = _weights(cfg)
    seqs, rows = [list(range(2, 60))], [list(range(20, 58))]
    full = ref_model.logits_at(weights, cfg, seqs, rows, block=16)
    zero = ref_model.logits_at(weights, dict(cfg, attention_windows=[0, 0]), seqs, rows, block=16)
    assert torch.equal(full[0], zero[0])
    win = ref_model.logits_at(weights, dict(cfg, attention_windows=[8, 0]), seqs, rows, block=16)
    assert not torch.allclose(full[0], win[0])
    with pytest.raises(ValueError, match="lists 1 layers, not 2"):
        ref_model.logits_at(weights, dict(cfg, attention_windows=[8]), seqs, rows)
