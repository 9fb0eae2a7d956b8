"""The port's shape cells and parameter trees against the JAX package's:
the three config helpers, ``ALL_SHAPES`` and ``shape_applicable`` over the
40 cells, ``input_specs`` leaf by leaf (meta tensors against
``jax.ShapeDtypeStruct``: shapes and dtypes equal, exactly) and
``Model.param_struct`` of every smoke arch (leaves, shapes and dtypes equal
to the reference's ``eval_shape`` of ``init``; nothing allocated)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import ALL_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.configs import shape_applicable as jax_shape_applicable  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ALL_SHAPES,
    ASSIGNED,
    get_config,
    input_specs,
    shape_applicable,
)
from repro_torch.models import build_model  # noqa: E402

ARCHS = [a for arch in ASSIGNED for a in (arch, arch + "-smoke")]


def _flat(tree, prefix=""):
    """{'a/b': leaf} of a tree of dicts."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _same_leaves(port: dict, ref: dict) -> None:
    """Every port leaf a meta tensor with the reference leaf's shape and
    dtype, and the same leaf names."""
    tp, tr = _flat(port), _flat(ref)
    assert sorted(tp) == sorted(tr)
    for name, leaf in tp.items():
        assert isinstance(leaf, torch.Tensor) and leaf.is_meta, name
        assert tuple(leaf.shape) == tuple(tr[name].shape), name
        assert str(leaf.dtype).removeprefix("torch.") == np.dtype(tr[name].dtype).name, name


@pytest.mark.parametrize("arch", ARCHS)
def test_config_helpers_equal_the_reference(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    for name in ("q_per_kv", "is_attention_free", "supports_long_context"):
        assert getattr(cfg, name) == getattr(ref, name), name


def test_shapes_and_their_applicability_equal_the_reference():
    assert {k: vars(v) for k, v in ALL_SHAPES.items()} == {
        k: vars(v) for k, v in JAX_SHAPES.items()}
    cells = [(a, s) for a in ASSIGNED for s in ALL_SHAPES]
    assert len(cells) == 40
    reasons = [shape_applicable(get_config(a), ALL_SHAPES[s]) for a, s in cells]
    assert reasons == [jax_shape_applicable(jax_get_config(a), JAX_SHAPES[s]) for a, s in cells]
    assert sum(r is not None for r in reasons) == 8


@pytest.mark.parametrize("arch", ASSIGNED)
@pytest.mark.parametrize("shape", list(ALL_SHAPES))
def test_input_specs_equal_the_reference(arch, shape):
    """Every cell, skipped ones too (their specs are still defined)."""
    port = input_specs(get_config(arch), ALL_SHAPES[shape])
    ref = jax_input_specs(jax_get_config(arch), JAX_SHAPES[shape])
    _same_leaves(port, ref)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_struct_equals_the_reference(arch):
    arch = arch + "-smoke"
    port = build_model(get_config(arch)).param_struct()
    ref = jax_build_model(jax_get_config(arch)).param_struct()
    _same_leaves(port, ref)


def test_param_struct_allocates_nothing_at_full_size():
    """llama3-8b's 8e9 parameters as meta tensors: their count is the
    config's, and no byte of them lives on the CPU."""
    tree = build_model(get_config("llama3-8b")).param_struct()
    leaves = list(_flat(tree).values())
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == get_config("llama3-8b").count_params()


def test_param_struct_has_init_s_shapes():
    """The tree `init` draws is the tree `param_struct` describes."""
    model = build_model(get_config("zamba2-2.7b-smoke"))
    real, meta = _flat(model.init(0, device="cpu")), _flat(model.param_struct())
    assert sorted(real) == sorted(meta)
    for name, t in real.items():
        assert (t.shape, t.dtype) == (meta[name].shape, meta[name].dtype), name
