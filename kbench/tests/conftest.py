import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


import json  # noqa: E402
import shutil  # noqa: E402
from typing import Optional  # noqa: E402

import pytest  # noqa: E402

KBENCH = ROOT / "kbench"


def tiny_files(tmp: Path, config: str = "minicpm-2b", loop: str = "open", limit: float = 0.05,
               reference: Optional[str] = "model"):
    """A throwaway configuration (the named one at smoke widths, naming
    ``reference``, or no reference where that is None) and traffic mix in
    ``tmp/kbench``, the repository's reference modules copied beside them,
    and a benchmark description with one cell over them; the repository's
    files are only read."""
    root = tmp / "kbench"
    (root / "configs").mkdir(parents=True)
    (root / "traffic").mkdir()
    shutil.copytree(KBENCH / "reference", root / "reference",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((KBENCH / "configs" / f"{config}.json").read_text())
    cfg.pop("reference")
    if reference is not None:
        cfg["reference"] = reference
    cfg.update(name="tiny", num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=128,
               vocab_size=256, max_len=256,
               num_kv_heads=4 if cfg["num_kv_heads"] == cfg["num_heads"] else 2)
    if cfg.get("num_experts"):
        cfg["num_experts"] = 4
    cfg["engine"].update(max_slots=4, decode_buckets=[1, 2, 4], chunk_size=64, page_size=16)
    # the configuration's own compared number, at the smoke size's limit
    number = next(iter(cfg["correct"]["limits"]))
    cfg["correct"].update(limits={number: limit}, sample_tokens=256, max_requests=24)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    lengths = dict(short_median=60, long_median=400, out_median_short=8, out_median_long=16,
                   max_output=24)
    if loop == "open":
        mix = dict(loop="open", rate=4.0, pool_seed=1, lead_in_s=1.0, lengths=lengths,
                   slo=dict(ttft_s=8, tpot_s=0.05))
    else:
        mix = dict(loop="closed", clients=4, pool_per_client=10, pool_seed=1, lead_in_s=1.0,
                   lengths=dict(lengths, long_frac=0.0), slo=dict(ttft_s=8, tpot_s=0.05))
    (root / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(name="tiny", source="test", file="kbench/configs/tiny.json",
                             reduced=[], why="test")]
    bench["workloads"] = [dict(name="tiny.throwaway", config="tiny", traffic="throwaway",
                               chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return bench, root


@pytest.fixture
def tiny(tmp_path):
    return lambda **kw: tiny_files(tmp_path, **kw)
