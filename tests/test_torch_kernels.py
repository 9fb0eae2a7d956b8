"""The port's attention kernels against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the JAX oracles over the sweep of tests/test_kernels.py (2e-5 f32,
2e-2 bf16) and against the JAX Pallas wrappers in interpret mode for the
unaligned and logit-cap cases. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as jax_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.prefill_attention.ops import prefill_attention as jax_prefill  # noqa: E402
from repro.kernels.prefill_attention.ref import prefill_attention_ref as jax_prefill_ref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    SPLIT_ROWS,
    decode_attention_ref,
    decode_attention_split_ref,
)
from repro_torch.kernels.prefill_attention.ops import prefill_attention  # noqa: E402
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref  # noqa: E402

# the tolerances of tests/test_kernels.py
_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

PREFILL_CASES = [
    (2, 128, 256, 4, 2, 64),
    (1, 64, 64, 8, 8, 128),  # MHA
    (2, 100, 300, 6, 2, 32),  # unaligned seq
    (1, 256, 512, 4, 1, 128),  # MQA
    (3, 32, 160, 4, 2, 16),  # tiny head dim
    (2, 96, 96, 4, 4, 80),  # zamba2's shared attention: MHA, head dim 80
]
DECODE_CASES = [
    (4, 512, 8, 2, 64),
    (2, 300, 4, 4, 128),
    (1, 1024, 16, 2, 32),
    (3, 96, 8, 1, 128),
    (2, 260, 4, 4, 80),  # zamba2's shared attention: qpk 1, head dim 80
]


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype`` (bf16
    rounds once, in JAX, and the tensor takes the rounded bits)."""
    j = jnp.asarray(a, _JNP[dtype])
    n = np.asarray(j)
    if dtype == "bfloat16":
        t = torch.from_numpy(n.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(n.copy())
    return j, t


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _prefill_inputs(rng, b, sq, skv, hq, hkv, dh, dtype, qscale=1.0):
    q = _both(rng.standard_normal((b, sq, hq, dh)) * qscale, dtype)
    k = _both(rng.standard_normal((b, skv, hkv, dh)) * qscale, dtype)
    v = _both(rng.standard_normal((b, skv, hkv, dh)), dtype)
    offs = rng.integers(0, skv - sq + 1, size=b)
    q_pos = offs[:, None] + np.arange(sq)[None, :]
    kv_len = offs + sq
    pos = (jnp.asarray(q_pos, jnp.int32), torch.tensor(q_pos, dtype=torch.int32))
    kvl = (jnp.asarray(kv_len, jnp.int32), torch.tensor(kv_len, dtype=torch.int32))
    return q, k, v, pos, kvl


@pytest.mark.parametrize("case", PREFILL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_plain_matches_jax_oracle(case, dtype, rng):
    q, k, v, pos, kvl = _prefill_inputs(rng, *case, dtype)
    ref = jax_prefill_ref(q[0], k[0], v[0], pos[0], kvl[0])
    out = prefill_attention_ref(q[1], k[1], v[1], pos[1], kvl[1])
    assert out.dtype == _TORCH[dtype] and out.shape == q[1].shape
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32), **_TOL[dtype])


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_oracle(case, dtype, rng):
    b, s, hq, hkv, dh = case
    q = _both(rng.standard_normal((b, hq, dh)), dtype)
    k = _both(rng.standard_normal((b, s, hkv, dh)), dtype)
    v = _both(rng.standard_normal((b, s, hkv, dh)), dtype)
    kv_len = rng.integers(1, s + 1, size=b)
    ref = jax_decode_ref(q[0], k[0], v[0], jnp.asarray(kv_len, jnp.int32))
    out = decode_attention_ref(q[1], k[1], v[1], torch.tensor(kv_len, dtype=torch.int32))
    assert out.dtype == _TORCH[dtype] and out.shape == q[1].shape
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32), **_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_wrapper_matches_pallas_interpret_unaligned(dtype, rng):
    """The port's wrapper (plain version on a CPU tensor) against the JAX
    Pallas wrapper in interpret mode on the unaligned 100 x 300 case."""
    q, k, v, pos, kvl = _prefill_inputs(rng, 2, 100, 300, 6, 2, 32, dtype)
    ref = jax_prefill(q[0], k[0], v[0], pos[0], kvl[0], block_q=64, block_k=64)
    out = prefill_attention(q[1], k[1], v[1], pos[1], kvl[1])
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32), **_TOL[dtype])


def test_prefill_wrapper_matches_pallas_interpret_logit_cap(rng):
    b, sq, skv, hq, hkv, dh = 1, 64, 128, 4, 2, 32
    q = _both(rng.standard_normal((b, sq, hq, dh)) * 3, "float32")
    k = _both(rng.standard_normal((b, skv, hkv, dh)) * 3, "float32")
    v = _both(rng.standard_normal((b, skv, hkv, dh)), "float32")
    q_pos = np.arange(sq)[None, :] + 64
    ref = jax_prefill(q[0], k[0], v[0], jnp.asarray(q_pos, jnp.int32), jnp.asarray([128]),
                      logit_cap=30.0, block_q=64, block_k=64)
    out = prefill_attention(q[1], k[1], v[1], torch.tensor(q_pos, dtype=torch.int32),
                            torch.tensor([128], dtype=torch.int32), logit_cap=30.0)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_decode_wrapper_matches_pallas_interpret_logit_cap(rng):
    b, s, hq, hkv, dh = 2, 300, 8, 2, 32
    q = _both(rng.standard_normal((b, hq, dh)) * 3, "float32")
    k = _both(rng.standard_normal((b, s, hkv, dh)) * 3, "float32")
    v = _both(rng.standard_normal((b, s, hkv, dh)), "float32")
    kv_len = np.array([300, 41])
    ref = jax_decode(q[0], k[0], v[0], jnp.asarray(kv_len, jnp.int32), logit_cap=30.0,
                     block_k=128)
    out = decode_attention(q[1], k[1], v[1], torch.tensor(kv_len, dtype=torch.int32),
                           logit_cap=30.0)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_decode_plain_ignores_stale_cache_tail(rng):
    """Entries past kv_len must not leak into the output (bit-identical)."""
    b, s, hq, hkv, dh = 2, 256, 4, 2, 32
    q = torch.tensor(rng.standard_normal((b, hq, dh)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((b, s, hkv, dh)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((b, s, hkv, dh)), dtype=torch.float32)
    kv_len = torch.tensor([100, 17], dtype=torch.int32)
    out1 = decode_attention(q, k, v, kv_len)
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:] = 1e4
    v2[:, 200:] = -1e4
    assert torch.equal(out1, decode_attention(q, k2, v2, kv_len))


# kv_len at and around the kernel's split boundaries, within one split and
# spanning several (S = 3 splits less a few rows)
SPLIT_KV_LENS = [1, SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1, 2 * SPLIT_ROWS, 3 * SPLIT_ROWS - 7]


@pytest.mark.parametrize("kv_len", SPLIT_KV_LENS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_arithmetic_matches_jax_oracle(kv_len, dtype, rng):
    """Per-split (m, l, acc) at the kernel's split length, merged in split
    order, is the same function as the plain version and the JAX oracle."""
    b, s, hq, hkv, dh = 2, 3 * SPLIT_ROWS - 7, 8, 2, 32
    q = _both(rng.standard_normal((b, hq, dh)), dtype)
    k = _both(rng.standard_normal((b, s, hkv, dh)), dtype)
    v = _both(rng.standard_normal((b, s, hkv, dh)), dtype)
    lens = np.array([kv_len, max(1, kv_len // 3)])
    ref = jax_decode_ref(q[0], k[0], v[0], jnp.asarray(lens, jnp.int32))
    kvl = torch.tensor(lens, dtype=torch.int32)
    out = decode_attention_split_ref(q[1], k[1], v[1], kvl)
    assert out.dtype == _TORCH[dtype] and out.shape == q[1].shape
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32), **_TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(decode_attention_ref(q[1], k[1], v[1], kvl)),
                               **_TOL[dtype])


def test_decode_split_arithmetic_logit_cap_and_stale_tail(rng):
    """The split arithmetic under a logit cap, and with NaN past kv_len:
    the output is bit-identical to the one with a clean tail."""
    b, s, hq, hkv, dh = 2, 2 * SPLIT_ROWS + 40, 4, 2, 16
    q = torch.tensor(rng.standard_normal((b, hq, dh)) * 3, dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((b, s, hkv, dh)) * 3, dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((b, s, hkv, dh)), dtype=torch.float32)
    kv_len = torch.tensor([SPLIT_ROWS + 3, 17], dtype=torch.int32)
    out = decode_attention_split_ref(q, k, v, kv_len, logit_cap=30.0)
    ref = jax_decode_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                         jnp.asarray(kv_len.numpy()), logit_cap=30.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    k2, v2 = k.clone(), v.clone()
    k2[0, SPLIT_ROWS + 3:] = float("nan")
    v2[0, SPLIT_ROWS + 3:] = float("nan")
    k2[1, 17:] = float("nan")
    v2[1, 17:] = float("nan")
    assert torch.equal(out, decode_attention_split_ref(q, k2, v2, kv_len, logit_cap=30.0))


def test_cpu_wrappers_do_not_launch(rng):
    """A CPU tensor takes the plain version and leaves the launch counts alone."""
    before = (prefill_attention.launches, decode_attention.launches)
    q, k, v, pos, kvl = _prefill_inputs(rng, 1, 8, 16, 4, 2, 16, "float32")
    prefill_attention(q[1], k[1], v[1], pos[1], kvl[1])
    decode_attention(q[1][:, 0].contiguous(), k[1], v[1], kvl[1])
    assert (prefill_attention.launches, decode_attention.launches) == before
