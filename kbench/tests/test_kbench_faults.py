"""The check catches a broken timed path: a run on the CPU at smoke widths
with a fault planted under the engine comes out not correct, and the sound
run beside them comes out correct. The harness's look for a card is the
only part of a run these skip. Also the control: the reference at float8
puts tokens first that the float32 reference ranks well below its best."""
import io
import time

import numpy as np
import pytest

import repro_torch.serving.engine as engine
from kbench.bench import run_cell
from kbench.correct import NUMBERS
from kbench.spec import load_cell


def _token_altered(server, monkeypatch):
    """Each decoded token replaced by its successor where it is sampled."""
    real = engine.sample
    monkeypatch.setattr(engine, "sample", lambda logits, **kw: (real(logits, **kw) + 1) % 256)


def _state_unchanged(server, monkeypatch):
    """The decode step returns the page pool unchanged: its new KV rows are
    never written back."""
    monkeypatch.setattr(engine, "scatter_pages", lambda cfg, pool, sub, idx: pool)


def _handoff_left_out(server, monkeypatch):
    """The prefill->decode KV handoff reserves pages but copies nothing."""
    dec = server.decode

    def attach(lr):
        lr.prefill_cache = None
        dec.prefix.assign_pages(lr.tokens[: lr.req.input_len], lr.page_table)

    monkeypatch.setattr(dec, "attach", attach)


def _half_the_batch(server, monkeypatch):
    """Only the first half of each decode batch is computed; the rest repeat
    their last token."""
    dec = server.decode
    real = dec.step

    def step(batch, gen):
        half = (len(batch) + 1) // 2
        rest = [lr.tokens[-1] for lr in batch[half:]]
        return np.concatenate([real(batch[:half], gen), np.array(rest, dtype=np.int32)])

    monkeypatch.setattr(dec, "step", step)


FAULTS = {"token altered": _token_altered, "state unchanged": _state_unchanged,
          "handoff left out": _handoff_left_out, "half the batch": _half_the_batch}


# the smoke sizes' limits of each configuration's compared number (the
# widest gap for the dense model, the mean gap for the mixture)
LIMIT = {"minicpm-2b": 0.05, "phi3.5-moe-16l": 0.05}


# a reference that differs from model.py: four hundred times the RoPE theta
OTHER_THETA = '''from kbench.reference import model


def logits_at(weights, m, seqs, rows, quant=None, block=512):
    return model.logits_at(weights, dict(m, rope_theta=400 * m["rope_theta"]), seqs, rows,
                           quant, block)
'''


def _run(tiny, monkeypatch, config, fault=None, control=None, seed=3, reference="model"):
    bench, root = tiny(config=config, loop="closed", limit=LIMIT[config], reference=reference)
    (root / "reference" / "other_theta.py").write_text(OTHER_THETA)
    cell = load_cell(bench, "tiny.throwaway", root=root)
    plant = None if fault is None else (lambda server: fault(server, monkeypatch))
    log = io.StringIO()
    r = run_cell(cell, seed, 3.0, False, time.monotonic(), device="cpu", log=log,
                 fault=plant, control=control)
    return r, log.getvalue()


@pytest.mark.parametrize("config", ["minicpm-2b", "phi3.5-moe-16l"])
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_makes_the_run_not_correct(tiny, monkeypatch, config, name):
    r, log = _run(tiny, monkeypatch, config, FAULTS[name])
    (gap,) = (v for k, v in r["checks"].items() if k != "checked_requests")
    assert r["correct"] is False and gap["value"] > gap["limit"], log


@pytest.mark.parametrize("config", ["minicpm-2b", "phi3.5-moe-16l"])
def test_sound_run_is_correct_and_the_control_is_not(tiny, monkeypatch, config):
    r, log = _run(tiny, monkeypatch, config, control=("fp8",))
    c = r["_check"]
    assert r["correct"] is True, log
    (number,) = c["values"]
    assert NUMBERS[number](c["readings"]["fp8"]) > LIMIT[config] > c["values"][number], log


@pytest.mark.parametrize("config", ["minicpm-2b", "phi3.5-moe-16l"])
@pytest.mark.parametrize("reference", ["model", "other_theta", None])
def test_the_check_calls_the_reference_the_configuration_names(tiny, monkeypatch, config,
                                                                 reference):
    """The same sound run is correct against ``model`` and not against a
    reference that differs from it; a configuration naming none fails."""
    if reference is None:
        with pytest.raises(ValueError, match="configuration 'tiny' names no reference"):
            _run(tiny, monkeypatch, config, reference=None)
        return
    r, log = _run(tiny, monkeypatch, config, reference=reference)
    assert r["correct"] is (reference == "model"), log
    assert f"reference {reference!r}" in log
