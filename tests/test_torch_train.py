"""The training slice of the port against ``repro.training`` and the JAX
model's loss: parameter counts, the synthetic data bit for bit, the WSD
schedule and AdamW within 1e-6, the loss within 2e-5 and every gradient
leaf within 1e-4 in relative norm for eight smoke configs (f32, the port's
``attn_impl`` "auto" and "pallas" against JAX's "auto"; labels with -100),
three train steps at 1 and 2 microbatches within 2e-4, checkpoints that
cross between the packages bit for bit, and the launcher.

The reference cannot differentiate its Pallas kernel (ROADMAP C8), so JAX
trains on "auto" here; the port's "pallas" runs the prefill kernel's
wrapper, whose plain versions (forward and backward) serve CPU tensors."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ALL_ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import checkpoint as jck  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

LOSS_TOL = 2e-5
GRAD_REL = 1e-4
STEP_TOL = dict(rtol=2e-4, atol=2e-4)
# the eight smoke configs of the slice, with a sequence length each: gemma2's
# window (32) must bind; the moe groups (32 tokens) must fill; chameleon is fed
# embeddings, so its token embedding is unused and its gradient zero (C9)
TRAIN_ARCHS = {
    "llama3-8b-smoke": 24,
    "minicpm-2b-smoke": 24,
    "gemma2-9b-smoke": 48,
    "phi3.5-moe-42b-a6.6b-smoke": 32,
    "mamba2-130m-smoke": 32,
    "zamba2-2.7b-smoke": 32,
    "seamless-m4t-medium-smoke": 32,
    "chameleon-34b-smoke": 24,
}
_JAX = {}


def _flat(tree, prefix=""):
    """{'a/b/c': leaf} of a tree of dicts."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(t):
    return t.detach().float().numpy()


def _jax_model(arch, groups=None):
    """(jax model, jax f32 params, their numpy copy), cached per arch (and
    ``ssm_ngroups``, where given)."""
    key = arch if groups is None else (arch, groups)
    if key not in _JAX:
        cfg = jax_get_config(arch).replace(dtype="float32")
        jm = jax_build_model(cfg if groups is None else cfg.replace(ssm_ngroups=groups))
        jp = jm.init(jax.random.key(0))
        _JAX[key] = (jm, jp, jax.tree.map(np.asarray, jp))
    return _JAX[key]


def _port(arch, np_params, impl="auto", groups=None):
    cfg = get_config(arch).replace(dtype="float32", attn_impl=impl)
    if groups is not None:
        cfg = cfg.replace(ssm_ngroups=groups)
    return build_model(cfg), params_from_jax(np_params, cfg, device="cpu")


def _batch(arch, seq, batch=2, step=0):
    """The reference's synthetic batch, with a few more labels set to -100."""
    cfg = jax_get_config(arch)
    b = jdata.SyntheticDataset(cfg, jdata.DataConfig(seq_len=seq, global_batch=batch)).batch_at(
        step)
    labels = b["labels"].copy()
    labels[:, 3] = -100
    labels[0, 5] = -100
    b["labels"] = labels
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


# --------------------------------------------------------------- param counts

@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_count_params_equal_jax(arch):
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS)
    for name in (arch, arch + "-smoke"):
        j, t = jax_get_config(name), get_config(name)
        assert t.count_params() == j.count_params(), name
        assert t.count_active_params() == j.count_active_params(), name


def test_minicpm_2b_is_about_2_7e9_parameters():
    n = get_config("minicpm-2b").count_params()
    assert 2.5e9 < n < 3.0e9


# ----------------------------------------------------------------------- data

@pytest.mark.parametrize("arch", ["llama3-8b-smoke", "chameleon-34b-smoke",
                                  "seamless-m4t-medium-smoke"])
def test_synthetic_batches_equal_the_reference_bit_for_bit(arch):
    """Tokens (dense), embeddings (vlm) and the encdec branch."""
    for dcfg in (dict(seq_len=16, global_batch=3), dict(seq_len=9, global_batch=2, seed=7,
                                                        vocab_cap=50)):
        j = jdata.SyntheticDataset(jax_get_config(arch), jdata.DataConfig(**dcfg))
        t = tdata.SyntheticDataset(get_config(arch), tdata.DataConfig(**dcfg))
        for step in (0, 1, 17):
            jb, tb = j.batch_at(step), t.batch_at(step)
            assert sorted(jb) == sorted(tb)
            for k in jb:
                assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), (arch, k)


# ------------------------------------------------------------------ optimizer

def test_wsd_schedule_equals_jax():
    cfg_kw = dict(lr=3e-4, warmup_steps=100, stable_steps=1000, decay_steps=100, min_lr_frac=0.1)
    jc, tc = jopt.OptimizerConfig(**cfg_kw), topt.OptimizerConfig(**cfg_kw)
    steps = np.arange(0, 1301, dtype=np.int32)
    j = np.asarray(jopt.wsd_schedule(jc, jnp.asarray(steps)))
    t = topt.wsd_schedule(tc, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    assert t.dtype == np.float32


def test_adamw_update_equals_jax(rng):
    """Five updates of a random f32 tree (clipping active at
    the first), from the same state, within 1e-6."""
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}

    def tree(fn, node=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in node.items()}

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    cfg = dict(lr=1e-2, warmup_steps=2, stable_steps=3, decay_steps=2)
    jc, tc = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_t = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tree_t)
    for i in range(5):
        grads = tree(lambda s, i=i: (rng.standard_normal(s) * (5.0 if i == 0 else 0.1))
                     .astype(np.float32))
        jp, js, jm = jopt.adamw_update(jc, jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts, tm = topt.adamw_update(tc, tp, jax.tree.map(torch.from_numpy, grads), ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, atol=1e-6)
        assert int(ts.step) == int(js.step) == i + 1
    for name, a in _flat(tp).items():
        np.testing.assert_allclose(a.numpy(), np.asarray(_flat(jp)[name]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_flat(ts.m)[name].numpy(), np.asarray(_flat(js.m)[name]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_flat(ts.v)[name].numpy(), np.asarray(_flat(js.v)[name]),
                                   rtol=1e-6, atol=1e-6)


def test_sliced_updates_equal_whole_ones(rng, monkeypatch):
    """`optimizer.slices` at 7 elements (leaves of 15, 7 and 16 elements,
    one non-contiguous grad taken whole) changes no bit of three AdamW
    updates (no clipping) nor of the f32 gradient accumulated over two
    microbatches, against whole leaves."""
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in (("a", (3, 5)), ("c", (7,)), ("d", (2, 2, 4)))}
    grads = [{k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    cfg = topt.OptimizerConfig(lr=1e-2, warmup_steps=2, stable_steps=3, decay_steps=2)
    arch = "llama3-8b-smoke"
    model, mparams = _port(arch, _jax_model(arch)[2])
    batch = _torch_batch(_batch(arch, 16))
    runs = []
    for size in (topt.SLICE, 7):
        monkeypatch.setattr(topt, "SLICE", size)
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        s = topt.init_opt_state(p)
        norms = []
        for g in grads:
            g = {k: torch.from_numpy(v) for k, v in g.items()}
            g["a"] = g["a"].t().contiguous().t()  # non-contiguous: taken whole
            p, s, m = topt.adamw_update(cfg, p, g, s)
            assert float(m["grad_norm"]) < 1.0  # no clipping: every bit must agree
            norms.append(float(m["grad_norm"]))
        _, acc = tts.loss_and_grad_accum(model, mparams, batch, 2)
        runs.append((p, s.m, s.v, norms, acc))
    (p0, m0, v0, n0, a0), (p1, m1, v1, n1, a1) = runs
    for whole, sliced in ((p0, p1), (m0, m1), (v0, v1), (a0, a1)):
        fw, fs = _flat(whole), _flat(sliced)
        assert all(torch.equal(fw[k], fs[k]) for k in fw), [k for k in fw
                                                           if not torch.equal(fw[k], fs[k])]
    np.testing.assert_allclose(n1, n0, rtol=1e-6)


# ------------------------------------------------------------ loss and grads

def _jax_loss_and_grads(arch, seq):
    key = ("grads", arch)
    if key not in _JAX:
        jm, jp, _ = _jax_model(arch)
        b = _batch(arch, seq)
        loss, grads = jax.jit(jax.value_and_grad(jm.loss))(jp, jax.tree.map(jnp.asarray, b))
        _JAX[key] = (float(loss), jax.tree.map(np.asarray, grads))
    return _JAX[key]


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("arch", list(TRAIN_ARCHS))
def test_loss_and_grads_match_jax(arch, impl):
    seq = TRAIN_ARCHS[arch]
    jloss, jgrads = _jax_loss_and_grads(arch, seq)
    model, params = _port(arch, _jax_model(arch)[2], impl)
    loss, grads = tts.loss_and_grad_accum(model, params, _torch_batch(_batch(arch, seq)), 1)
    assert abs(float(loss) - jloss) <= LOSS_TOL, (float(loss), jloss)
    jflat, tflat = _flat(jgrads), _flat(grads)
    assert sorted(jflat) == sorted(tflat)
    for name, jg in jflat.items():
        diff = np.linalg.norm(_np(tflat[name]) - jg)
        assert diff <= GRAD_REL * max(np.linalg.norm(jg), 1e-6), (name, diff, np.linalg.norm(jg))


@pytest.mark.parametrize("groups", [2, 4, 8])
@pytest.mark.parametrize("arch", ["mamba2-130m-smoke", "zamba2-2.7b-smoke"])
def test_grouped_loss_and_grads_match_jax(arch, groups):
    """The SSM families with several groups of B and C (8 heads: 4, 2 and 1
    a group), the scan under autograd of its plain version (the CPU path of
    `ssd`): the loss and every gradient leaf against JAX's."""
    seq = TRAIN_ARCHS[arch]
    jm, jp, np_params = _jax_model(arch, groups)
    b = _batch(arch, seq)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jax.tree.map(jnp.asarray, b))
    model, params = _port(arch, np_params, "pallas", groups)
    loss, grads = tts.loss_and_grad_accum(model, params, _torch_batch(b), 1)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL, (float(loss), float(jloss))
    jflat, tflat = _flat(jax.tree.map(np.asarray, jgrads)), _flat(grads)
    assert sorted(jflat) == sorted(tflat)
    for name, jg in jflat.items():
        diff = np.linalg.norm(_np(tflat[name]) - jg)
        assert diff <= GRAD_REL * max(np.linalg.norm(jg), 1e-6), (name, diff, np.linalg.norm(jg))


def test_loss_ignores_minus_100_labels():
    """Every label -100: the loss is 0 (the reference's masked mean over a
    denominator clamped to 1), not an index error."""
    arch = "llama3-8b-smoke"
    model, params = _port(arch, _jax_model(arch)[2])
    b = _torch_batch(_batch(arch, 16))
    b["labels"] = torch.full_like(b["labels"], -100)
    assert float(model.loss(params, b)) == 0.0


def test_forward_train_remat_changes_nothing():
    arch = "llama3-8b-smoke"
    model, params = _port(arch, _jax_model(arch)[2])
    b = _torch_batch(_batch(arch, 16))
    a = model.forward_train(params, b, remat=True)
    c = model.forward_train(params, b, remat=False)
    assert a.shape == (2, 16, get_config(arch).vocab_size) and a.dtype == torch.float32
    assert torch.equal(a, c)
    la, ga = tts.loss_and_grad_accum(model, params, b, 1)
    model_nr = type(model)(model.cfg)
    lc = model_nr.loss(params, b, remat=False)
    assert float(la) == float(lc)
    assert all(g.grad_fn is None for g in _flat(ga).values())


# ------------------------------------------------------------------ the step

@pytest.mark.parametrize("n_micro", [1, 2])
def test_three_train_steps_match_jax(n_micro):
    arch = "llama3-8b-smoke"
    jm, jp, np_params = _jax_model(arch)
    model, params = _port(arch, np_params)
    opt_cfg = dict(lr=1e-3, warmup_steps=2, stable_steps=10, decay_steps=2)
    jstep = jax.jit(jts.make_train_step(jm, jopt.OptimizerConfig(**opt_cfg), n_micro=n_micro))
    tstep = tts.make_train_step(model, topt.OptimizerConfig(**opt_cfg), n_micro=n_micro)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(params)
    for step in range(3):
        b = _batch(arch, 16, batch=4, step=step)
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        params, ts, tmet = tstep(params, ts, _torch_batch(b))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= LOSS_TOL
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-4)
    jflat = _flat(jax.tree.map(np.asarray, jp))
    for name, t in _flat(params).items():
        np.testing.assert_allclose(_np(t), jflat[name], err_msg=name, **STEP_TOL)


def test_split_batch_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="microbatches"):
        tts._split_batch({"inputs": torch.zeros(3, 4)}, 2)


def test_default_microbatches_equal_jax():
    cfg = get_config("llama3-8b")
    for gb in (1, 63, 64, 255, 256, 1024):
        assert tts.default_microbatches(cfg, gb) == jts.default_microbatches(
            jax_get_config("llama3-8b"), gb)


# ------------------------------------------------------------- checkpoints

def _ckpt_trees(rng):
    """The same {"params", "opt"} tree in both packages: llama3-8b-smoke in
    bf16 (the uint16 path) with random moments at step 7."""
    arch = "llama3-8b-smoke"
    jm = jax_build_model(jax_get_config(arch))
    jp = jm.init(jax.random.key(1))
    nump = jax.tree.map(np.asarray, jp)
    moments = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), nump)
               for _ in range(2)]
    jtree = {"params": jp, "opt": jopt.OptState(step=jnp.int32(7),
                                                m=jax.tree.map(jnp.asarray, moments[0]),
                                                v=jax.tree.map(jnp.asarray, moments[1]))}
    cfg = get_config(arch)
    ttree = {"params": params_from_jax(nump, cfg, device="cpu"),
             "opt": topt.OptState(step=torch.tensor(7, dtype=torch.int32),
                                  m=jax.tree.map(torch.from_numpy, moments[0]),
                                  v=jax.tree.map(torch.from_numpy, moments[1]))}
    return jtree, ttree


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tbits(t) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _leaves_by_key(tree, keyfn):
    return {keyfn(p): v for p, v in tree}


def test_checkpoints_cross_between_the_packages_bit_for_bit(tmp_path, rng):
    jtree, ttree = _ckpt_trees(rng)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck.CheckpointManager(jdir).save(7, jtree)
    tmgr = tck.CheckpointManager(tdir)
    tmgr.save(7, ttree, async_=True)
    tmgr.join()
    # the same files, manifests and bytes
    jfiles, tfiles = sorted(os.listdir(jdir + "/step_7")), sorted(os.listdir(tdir + "/step_7"))
    assert jfiles == tfiles and "opt__.step.npy" in jfiles and "params__embed.npy" in jfiles
    for d in (jdir, tdir):
        assert sorted(os.listdir(d)) == ["LATEST", "step_7"]
    with open(jdir + "/step_7/manifest.json") as f, open(tdir + "/step_7/manifest.json") as g:
        assert json.load(f) == json.load(g)
    for name in jfiles:
        with open(f"{jdir}/step_7/{name}", "rb") as f, open(f"{tdir}/step_7/{name}", "rb") as g:
            assert f.read() == g.read(), name
    # JAX's checkpoint restored by the port, the port's by JAX
    like_t = jax.tree.map(torch.zeros_like, ttree)
    got_t, step = tck.CheckpointManager(jdir).restore(like_t)
    assert step == 7 and type(got_t["opt"]) is topt.OptState
    got_j, step = jck.CheckpointManager(tdir).restore(jax.tree.map(jnp.zeros_like, jtree))
    assert step == 7
    jl = _leaves_by_key(jax.tree_util.tree_flatten_with_path(jtree)[0], jck._path_key)
    for key, t in _leaves_by_key(tck._flatten_with_path(got_t), tck._path_key).items():
        assert t.dtype == _leaves_by_key(tck._flatten_with_path(ttree), tck._path_key)[key].dtype
        assert np.array_equal(_tbits(t), _bits(jl[key])), key
    tl = _leaves_by_key(tck._flatten_with_path(ttree), tck._path_key)
    for key, a in _leaves_by_key(jax.tree_util.tree_flatten_with_path(got_j)[0],
                                 jck._path_key).items():
        assert np.array_equal(_bits(a), _tbits(tl[key])), key


def test_checkpoint_manager_keeps_the_newest_and_survives_a_dead_writer(tmp_path):
    ck = tck.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    for s in (1, 2, 3):
        tree["w"] += 1  # the caller updates in place after an async save
        ck.save(s, tree, async_=True)
    ck.join()
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_2", "step_3"]
    os.makedirs(tmp_path / "step_9.tmp")  # a writer killed mid-save
    got, step = ck.restore({"w": torch.zeros(4)})
    assert step == 3 and torch.equal(got["w"], torch.arange(4, dtype=torch.float32) + 3)
    got, _ = ck.restore({"w": torch.zeros(4)}, step=2)
    assert torch.equal(got["w"], torch.arange(4, dtype=torch.float32) + 2)


# ------------------------------------------------------------------ launcher

def test_train_launcher_runs_three_steps_on_the_cpu(tmp_path, capsys):
    train_cli.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                    "--n-micro", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "step     0 loss=" in out and "step     2 loss=" in out
    assert (tmp_path / "step_3" / "manifest.json").exists()
    train_cli.main(["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
                    "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "resumed at step 3" in out and "step     3 loss=" in out


def test_train_launcher_raises_without_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--steps", "1"])
