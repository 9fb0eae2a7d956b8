"""The port on a real multi-rank mesh (its ``test_multihost_mesh.py``): 8 gloo
processes on the CPU, one ``("data", "model")`` mesh of (2, 4), against
the JAX package on one device.

A module-scoped fixture spawns the 8 ranks once (`_worker`, the same file
with ``--worker``), with a timeout of its own so that a hung rank fails the
tests instead of hanging the suite; rank 0 prints one JSON line, and the
tests assert on it. The JAX reference runs in the test process, on the
same weights (saved to an ``.npz`` the ranks read) and inputs.

- llama3-8b-smoke, f32, ``attn_impl="pallas"``: the attention takes the
  kernels' wrappers through ``local_map`` (their plain versions on CPU
  tensors), with 2 KV heads on a 4-wide model axis, the GQA case where the
  K/V heads stay replicated and each rank takes the one its query head
  reads. Zero fallbacks for the smoke's divisible dims; a sharded leaf's
  global sum; a vocab of 250 falls back as in the reference; a prefill of 2
  prompts and 4 greedy decode steps give the JAX tokens exactly, with
  logits within 2e-4; a chunked prefill at per-row offsets into a placed
  cache equals the unsharded port's; one training step with 2 microbatches and
  ``grad_shardings`` / ``micro_shardings`` gives a loss within 2e-5 of
  JAX's, and every updated leaf within 1e-4 of the unsharded port's step;
  so does a step of one microbatch with no shardings given.
- The collectives of a training step of llama, grok and zamba2, counted
  on meta tensors as the dry-run counts them, equal the ones the step
  issues with data, by mesh dim, kind, calls and bytes.
- Every kernel wrapper that ``local_map`` routes (attention, SSD scan)
  refuses a DTensor.
- An embedding table split on its vocab dim (`dist.dtensor.vocab_lookup`):
  the rows and the table's gradient equal the plain lookup's.
- grok-1-314b-smoke: the expert layer's ``local_map`` route, a prefill
  within 2e-4 of JAX and a training step (each rank routing whole groups
  of its own rows) whose loss is within 2e-5 and every leaf within 1e-4 of
  the unsharded port's.
- zamba2-2.7b-smoke: a prefill through the SSD scan's ``local_map`` route,
  within 2e-4 of JAX, and a training step through it; and at
  ``ssm_ngroups=2`` (8 heads, 2 a rank on the model axis, inside one group
  of 4) a prefill of unpadded prompts and 4 greedy decode steps that give
  JAX's tokens.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD, MESH = 8, (2, 4)
SPAWN_TIMEOUT = 240  # seconds for all ranks; a hung rank fails the fixture
PROMPT_LEN, VALID = 12, (12, 7)
DECODE_STEPS, MAX_LEN = 4, 32
TRAIN_B, TRAIN_S, N_MICRO = 4, 16, 2
OPT = dict(lr=1e-3, warmup_steps=1, stable_steps=10, decay_steps=2)
LOGIT_TOL, LOSS_TOL, LEAF_REL = 2e-4, 2e-5, 1e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _inputs(vocab):
    rng = np.random.default_rng(0)
    toks = rng.integers(2, vocab, (2, PROMPT_LEN))
    train = rng.integers(2, vocab, (TRAIN_B, TRAIN_S + 1))
    labels = train[:, 1:].copy()
    labels[0, -3:] = -100
    return toks, dict(inputs=train[:, :-1], labels=labels)


# --------------------------------------------------------------------- worker

def _worker(rank: int, port: int, tmp: str) -> None:
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        out = _rank_checks(tmp)
        if rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def _rank_checks(tmp: str) -> dict:
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.dist.act_sharding import use_activation_sharding
    from repro_torch.dist.sharding import (
        ShardingPlan,
        cache_pspecs,
        distribute,
        input_pspecs,
        named,
        param_pspecs,
        placements,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, layers
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.transformer import handoff
    from repro_torch.roofline import op_stats
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state, tree_leaves
    from repro_torch.training.train_step import make_train_step

    mesh = make_mesh(MESH, ("data", "model"), device="cpu")
    out: dict = {}

    def counted_collectives(model, cfg, specs, step, batch, plan):
        """The collectives of ``step`` counted on meta tensors (the dry-run's
        route), by mesh dim and kind."""
        mparams = distribute(model.param_struct(), specs, mesh)
        mbatch = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
        with use_activation_sharding(mesh, plan.batch_axes):
            stats = op_stats.count(step, mparams, init_opt_state(mparams), mbatch)
        return op_stats.by_mesh_dim(stats, mesh)

    # the kernels' wrappers, reached with local tensors only
    seen = {"prefill": 0, "decode": 0, "dtensor": 0}
    for name in ("prefill", "decode"):
        orig = getattr(layers, f"{name}_attention")

        def spy(q, *a, _orig=orig, _name=name, **kw):
            seen[_name] += 1
            seen["dtensor"] += isinstance(q, DTensor)
            return _orig(q, *a, **kw)

        setattr(layers, f"{name}_attention", spy)

    def load(arch, groups=1):
        cfg = get_config(arch).replace(dtype="float32", attn_impl="pallas", ssm_ngroups=groups)
        name = arch if groups == 1 else f"{arch}-g{groups}"
        with np.load(os.path.join(tmp, f"{name}.npz")) as z:
            params = params_from_jax(_unflat(dict(z)), cfg, device="cpu")
        return cfg, build_model(cfg), params

    cfg, model, params = load("llama3-8b-smoke")
    toks, batch = _inputs(cfg.vocab_size)
    toks = torch.tensor(toks)
    valid = torch.tensor(VALID, dtype=torch.int32)

    # the plan: fallbacks, one sharded leaf placed and summed over the mesh
    plan = ShardingPlan(mesh, mode="train")
    specs = param_pspecs(cfg, params, plan)
    out["clean_fallbacks"] = list(plan.fallbacks)
    flat_p, flat_s = _flat(params), _flat(specs)
    sharded = [k for k in flat_p if "model" in tuple(flat_s[k])]
    leaf = max(sharded, key=lambda k: (flat_p[k].dim(), k))
    dt = distribute_tensor(torch.ones(flat_p[leaf].shape), mesh, placements(flat_s[leaf], mesh))
    out.update(n_model_sharded=len(sharded), placed_leaf_shape=list(dt.shape),
               placed_local_shape=list(dt.to_local().shape),
               placed_axis=tuple(flat_s[leaf]).index("model"),
               placed_sum=float(torch.sum(dt).full_tensor()))
    bad = ShardingPlan(mesh)
    param_pspecs(cfg.replace(vocab_size=250), build_model(cfg.replace(vocab_size=250))
                 .param_struct(), bad)
    out["bad_fallbacks"] = list(bad.fallbacks)

    # prefill and greedy decode on the mesh
    splan = ShardingPlan(mesh, mode="serve")
    dparams = distribute(params, param_pspecs(cfg, params, splan), mesh)
    with use_activation_sharding(mesh, splan.batch_axes):
        logits, kv = model.prefill(dparams, {"inputs": toks}, valid)
        cache = model.init_cache(2, MAX_LEN, device="cpu")
        cache = handoff(cfg, kv, distribute(cache, cache_pspecs(cfg, cache, splan), mesh))
        rows, toks_out = [logits.full_tensor()], []
        tok, pos = rows[0].argmax(-1), valid.clone()
        for _ in range(DECODE_STEPS):
            toks_out.append(tok.tolist())
            logits, cache = model.decode(dparams, tok[:, None], pos, cache)
            rows.append(logits.full_tensor())
            tok, pos = rows[-1].argmax(-1), pos + 1
    calls = dict(seen)  # the prefill's and the decode steps'

    # a chunked prefill at per-row offsets into a placed cache, against the
    # unsharded port's (each rank writes its own rows)
    from repro_torch.models.transformer import chunk_prefill_step

    chunk, starts, valids = toks[:, :8], [0, 3], [8, 5]
    plain_cache = model.init_cache(2, MAX_LEN, device="cpu")
    placed_cache = distribute(model.init_cache(2, MAX_LEN, device="cpu"),
                              cache_pspecs(cfg, plain_cache, splan), mesh)
    want, plain_cache = chunk_prefill_step(params, chunk, starts, valids, cfg, plain_cache)
    with use_activation_sharding(mesh, splan.batch_axes):
        got, placed_cache = chunk_prefill_step(dparams, chunk, starts, valids, cfg, placed_cache)
    out["chunk_err"] = float((got.full_tensor() - want).abs().max())
    out["chunk_cache_err"] = float((placed_cache["k"].full_tensor() - plain_cache["k"]).abs().max())
    out.update(tokens=toks_out, logits=[r.tolist() for r in rows],
               logits_dtensor=isinstance(logits, DTensor), kernel_calls=calls,
               cache_placements=[repr(p) for p in cache["k"].placements])

    # one training step, 2 microbatches, against the unsharded port's
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    micro = {k: v[: TRAIN_B // N_MICRO] for k, v in tb.items()}
    # its own copy: each rank's shard may be a view of ``params``, which the
    # plain step below updates in place
    dparams = distribute(_unflat({k: v.clone() for k, v in _flat(params).items()}), specs, mesh)
    dstep = make_train_step(model, OptimizerConfig(**OPT), n_micro=N_MICRO,
                            grad_shardings=named(mesh, specs),
                            micro_shardings=named(mesh, input_pspecs(cfg, micro, plan)))
    real = op_stats.OpStats()
    with use_activation_sharding(mesh, plan.batch_axes), op_stats._Comms(real):
        dparams, dopt, dmet = dstep(dparams, init_opt_state(dparams), tb)
    out["llama_collectives"] = [op_stats.by_mesh_dim(real, mesh),
                                counted_collectives(model, cfg, specs, dstep, tb, plan)]
    # one microbatch, no shardings given: AdamW settles each gradient's
    # pending sums before the clip norm
    dparams1 = distribute(_unflat({k: v.clone() for k, v in _flat(params).items()}), specs, mesh)
    with use_activation_sharding(mesh, plan.batch_axes):
        dparams1, _, dmet1 = make_train_step(model, OptimizerConfig(**OPT))(
            dparams1, init_opt_state(dparams1), tb)
    params1 = _unflat({k: v.clone() for k, v in _flat(params).items()})
    plain1, _, met1 = make_train_step(model, OptimizerConfig(**OPT))(
        params1, init_opt_state(params1), tb)
    out["one_micro"] = dict(
        loss=[float(dmet1["loss"]), float(met1["loss"])],
        grad_norm=[float(dmet1["grad_norm"]), float(met1["grad_norm"])],
        leaf_rel={k: float((a - b.full_tensor()).norm() / a.norm().clamp(min=1e-30))
                  for (k, a), b in zip(_flat(plain1).items(), tree_leaves(dparams1),
                                       strict=True)})
    step = make_train_step(model, OptimizerConfig(**OPT), n_micro=N_MICRO)
    plain, _, met = step(params, init_opt_state(params), tb)
    errs = {k: float((a - b.full_tensor()).norm() / a.norm().clamp(min=1e-30))
            for (k, a), b in zip(_flat(plain).items(), tree_leaves(dparams), strict=True)}
    out.update(loss=float(dmet["loss"]), plain_loss=float(met["loss"]),
               grad_norm=float(dmet["grad_norm"]), plain_grad_norm=float(met["grad_norm"]),
               leaf_rel=errs,
               moments_placed=all(tuple(m.placements) == tuple(p.placements)
                                  for m, p in zip(tree_leaves(dopt.m), tree_leaves(dparams),
                                                  strict=True)))

    # an embedding split on its vocab dim: each rank's own rows, a sum over
    # the model axis, and the table's gradient on its own rows
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.dtensor import vocab_lookup

    g = torch.Generator().manual_seed(3)
    table, w = torch.randn(256, 64, generator=g), torch.randn(4, 6, 64, generator=g)
    ids = torch.randint(0, 256, (4, 6), generator=g)
    dt_table = distribute_tensor(table.clone(), mesh, [Replicate(), Shard(0)],
                                 src_data_rank=None).requires_grad_(True)
    looked = vocab_lookup(dt_table, distribute_tensor(ids, mesh, [Shard(0), Replicate()],
                                                      src_data_rank=None))
    dw = distribute_tensor(w, mesh, [Replicate(), Replicate()], src_data_rank=None)
    (looked * dw).sum().full_tensor().backward()
    ref = table.clone().requires_grad_(True)
    (torch.nn.functional.embedding(ids, ref) * w).sum().backward()
    out["vocab_lookup_err"] = float((looked.full_tensor() - ref.detach()[ids]).abs().max())
    out["vocab_grad_err"] = float((dt_table.grad.full_tensor() - ref.grad).abs().max())
    out["vocab_grad_placements"] = [repr(p) for p in dt_table.grad.placements]

    # every wrapper local_map routes refuses a DTensor before it reads a pointer
    import inspect

    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.prefill_attention import ops as pops
    from repro_torch.kernels.ssd_scan import ops as sops

    placed = distribute_tensor(torch.ones(4, 8), mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
    out["refusals"] = {}
    for fn in (dops.decode_attention, pops.prefill_attention, pops.prefill_attention_fwd,
               pops.prefill_attention_bwd, sops.ssd, sops.ssd_fwd, sops.ssd_bwd):
        n = sum(q.default is q.empty for q in inspect.signature(fn).parameters.values())
        try:
            fn(*[placed] * n)
            out["refusals"][fn.__name__] = "no error"
        except TypeError as e:
            out["refusals"][fn.__name__] = str(e)

    # grok-1 (moe): the expert layer's local_map route, rows whole (a rank's
    # 12 of 24 prompt tokens would cut the group), then split (2 x 32 tokens
    # a microbatch, one group a rank) in a training step
    gcfg, gmodel, gparams = load("grok-1-314b-smoke")
    gplan = ShardingPlan(mesh, mode="train")
    gspecs = param_pspecs(gcfg, gparams, gplan)
    gd = distribute(_unflat({k: v.clone() for k, v in _flat(gparams).items()}), gspecs, mesh)
    with use_activation_sharding(mesh, gplan.batch_axes):
        gl, _ = gmodel.prefill(gd, {"inputs": toks}, valid)
    out["grok_logits"] = gl.full_tensor().tolist()
    rng = np.random.default_rng(1)
    seq = rng.integers(2, gcfg.vocab_size, (TRAIN_B, 2 * TRAIN_S + 1))
    gb = dict(inputs=torch.tensor(seq[:, :-1]), labels=torch.tensor(seq[:, 1:]))
    gstep = make_train_step(gmodel, OptimizerConfig(**OPT), n_micro=N_MICRO,
                            grad_shardings=named(mesh, gspecs),
                            micro_shardings=named(mesh, input_pspecs(
                                gcfg, {k: v[: TRAIN_B // N_MICRO] for k, v in gb.items()},
                                gplan)))
    real = op_stats.OpStats()
    with use_activation_sharding(mesh, gplan.batch_axes), op_stats._Comms(real):
        gd, _, gmet = gstep(gd, init_opt_state(gd), gb)
    out["grok_collectives"] = [op_stats.by_mesh_dim(real, mesh),
                               counted_collectives(gmodel, gcfg, gspecs, gstep, gb, gplan)]
    gplain, _, gpmet = make_train_step(gmodel, OptimizerConfig(**OPT), n_micro=N_MICRO)(
        gparams, init_opt_state(gparams), gb)
    out["grok_loss"] = [float(gmet["loss"]), float(gpmet["loss"])]
    out["grok_leaf_rel"] = {
        k: float((a - b.full_tensor()).norm() / a.norm().clamp(min=1e-30))
        for (k, a), b in zip(_flat(gplain).items(), tree_leaves(gd), strict=True)}

    # zamba2: the SSD scan's local_map route
    zcfg, zmodel, zparams = load("zamba2-2.7b-smoke")
    zplan = ShardingPlan(mesh, mode="serve")
    zd = distribute(zparams, param_pspecs(zcfg, zparams, zplan), mesh)
    with use_activation_sharding(mesh, zplan.batch_axes):
        zl, _ = zmodel.prefill(zd, {"inputs": toks}, valid)
    out["zamba2_logits"] = zl.full_tensor().tolist()
    zplan = ShardingPlan(mesh, mode="train")
    zspecs = param_pspecs(zcfg, zparams, zplan)
    zd = distribute(_unflat({k: v.clone() for k, v in _flat(zparams).items()}), zspecs, mesh)
    zstep = make_train_step(zmodel, OptimizerConfig(**OPT), n_micro=N_MICRO,
                            grad_shardings=named(mesh, zspecs),
                            micro_shardings=named(mesh, input_pspecs(zcfg, micro, zplan)))
    real = op_stats.OpStats()
    with use_activation_sharding(mesh, zplan.batch_axes), op_stats._Comms(real):
        zstep(zd, init_opt_state(zd), tb)
    out["zamba2_collectives"] = [op_stats.by_mesh_dim(real, mesh),
                                 counted_collectives(zmodel, zcfg, zspecs, zstep, tb, zplan)]

    # zamba2 at 2 groups of B and C: each rank's heads read one group
    gcfg, gmodel, gparams = load("zamba2-2.7b-smoke", groups=2)
    gplan = ShardingPlan(mesh, mode="serve")
    gd = distribute(gparams, param_pspecs(gcfg, gparams, gplan), mesh)
    with use_activation_sharding(mesh, gplan.batch_axes):
        logits, kv = gmodel.prefill(gd, {"inputs": toks})
        cache = gmodel.init_cache(2, MAX_LEN, device="cpu")
        cache = handoff(gcfg, kv, distribute(cache, cache_pspecs(gcfg, cache, gplan), mesh))
        tok, pos, gtoks = logits.full_tensor().argmax(-1), torch.full((2,), PROMPT_LEN), []
        for _ in range(DECODE_STEPS):
            gtoks.append(tok.tolist())
            logits, cache = gmodel.decode(gd, tok[:, None], pos, cache)
            tok, pos = logits.full_tensor().argmax(-1), pos + 1
    out["zamba2_g2_tokens"] = gtoks
    return out


# ---------------------------------------------------------------------- tests

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_reference(tmp: Path) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.models import transformer as jt
    from repro.training import optimizer as jopt
    from repro.training import train_step as jts

    ref = {}
    for arch in ("llama3-8b-smoke", "zamba2-2.7b-smoke", "grok-1-314b-smoke"):
        cfg = jax_get_config(arch).replace(dtype="float32")
        model = jax_build_model(cfg)
        params = model.init(jax.random.key(0))
        np.savez(tmp / f"{arch}.npz", **_flat(jax.tree.map(np.asarray, params)))
        toks, batch = _inputs(cfg.vocab_size)
        valid = jnp.asarray(VALID, jnp.int32)
        logits, kv = jt.prefill_step(params, jnp.asarray(toks, jnp.int32), cfg, valid)
        if not arch.startswith("llama3"):
            ref[arch.split("-")[0] + "_logits"] = np.asarray(logits)
            continue
        cache = model.init_cache(2, MAX_LEN)
        cache = {n: cache[n].at[:, :, :PROMPT_LEN].set(t) for n, t in zip("kv", kv, strict=True)}
        rows, toks_out = [np.asarray(logits)], []
        tok, pos = jnp.argmax(logits, -1), valid
        for _ in range(DECODE_STEPS):
            toks_out.append(np.asarray(tok).tolist())
            logits, cache = jt.decode_step(params, tok[:, None].astype(jnp.int32), pos, cfg,
                                           cache)
            rows.append(np.asarray(logits))
            tok, pos = jnp.argmax(logits, -1), pos + 1
        ref.update(tokens=toks_out, logits=rows)
        step = jax.jit(jts.make_train_step(model, jopt.OptimizerConfig(**OPT), n_micro=N_MICRO))
        _, _, met = step(params, jopt.init_opt_state(params),
                         {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
        ref["loss"] = float(met["loss"])
    # zamba2 at 2 groups: unpadded prompts (the reference keeps padding in
    # its conv window, ROADMAP C2), then greedy decode from its own cache
    arch = "zamba2-2.7b-smoke"
    cfg = jax_get_config(arch).replace(dtype="float32", ssm_ngroups=2)
    model = jax_build_model(cfg)
    params = model.init(jax.random.key(0))
    np.savez(tmp / f"{arch}-g2.npz", **_flat(jax.tree.map(np.asarray, params)))
    toks, _ = _inputs(cfg.vocab_size)
    logits, (rec, (k, v)) = model.prefill(params, dict(inputs=jnp.asarray(toks, jnp.int32)))
    pad = ((0, 0), (0, 0), (0, MAX_LEN - k.shape[2]), (0, 0), (0, 0))
    cache = dict(conv=rec["conv"], state=rec["state"], k=jnp.pad(k, pad), v=jnp.pad(v, pad))
    tok, pos, ref["zamba2_g2_tokens"] = jnp.argmax(logits, -1), PROMPT_LEN, []
    for _ in range(DECODE_STEPS):
        ref["zamba2_g2_tokens"].append(np.asarray(tok).tolist())
        logits, cache = model.decode(params, tok[:, None].astype(jnp.int32),
                                     jnp.full((2,), pos, jnp.int32), cache)
        tok, pos = jnp.argmax(logits, -1), pos + 1
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank")
    ref = _jax_reference(tmp)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(port), str(tmp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank ran past {SPAWN_TIMEOUT} s")
    for r, (p, (_, err)) in enumerate(zip(procs, outs, strict=True)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    return json.loads(outs[0][0].strip().splitlines()[-1]), ref


def test_plan_on_the_mesh(run):
    got, _ = run
    assert got["clean_fallbacks"] == []
    assert got["n_model_sharded"] >= 3
    ax = got["placed_axis"]
    assert got["placed_local_shape"][ax] * MESH[1] == got["placed_leaf_shape"][ax]
    assert got["placed_sum"] == float(np.prod(got["placed_leaf_shape"]))
    assert any("250" in f and "replicated" in f for f in got["bad_fallbacks"])


def test_prefill_and_greedy_decode_give_the_jax_tokens(run):
    got, ref = run
    assert got["tokens"] == ref["tokens"]
    assert len(got["logits"]) == len(ref["logits"]) == DECODE_STEPS + 1
    for a, b in zip(got["logits"], ref["logits"], strict=True):
        np.testing.assert_allclose(np.asarray(a), b, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert got["logits_dtensor"]
    # prefill: one call a layer; decode: one a layer a step; never a DTensor
    calls = got["kernel_calls"]
    assert calls == {"prefill": 2, "decode": 2 * DECODE_STEPS, "dtensor": 0}
    # 2 KV heads on the 4-wide model axis: the cache's heads stay whole
    assert got["cache_placements"] == ["Shard(dim=1)", "Replicate()"]


def test_chunked_prefill_into_a_placed_cache_matches_the_unsharded_port(run):
    got, _ = run
    assert got["chunk_err"] <= LOGIT_TOL
    assert got["chunk_cache_err"] <= LOGIT_TOL


def test_sharded_train_step_matches_jax_and_the_unsharded_port(run):
    got, ref = run
    assert abs(got["loss"] - ref["loss"]) <= LOSS_TOL
    assert abs(got["loss"] - got["plain_loss"]) <= LOSS_TOL
    np.testing.assert_allclose(got["grad_norm"], got["plain_grad_norm"], rtol=1e-5)
    bad = {k: e for k, e in got["leaf_rel"].items() if not e <= LEAF_REL}
    assert not bad
    assert got["moments_placed"]


def test_one_microbatch_without_shardings_matches_the_unsharded_port(run):
    got, _ = run
    one = got["one_micro"]
    assert abs(one["loss"][0] - one["loss"][1]) <= LOSS_TOL
    np.testing.assert_allclose(one["grad_norm"][0], one["grad_norm"][1], rtol=1e-5)
    bad = {k: e for k, e in one["leaf_rel"].items() if not e <= LEAF_REL}
    assert not bad


@pytest.mark.parametrize("arch", ["llama", "grok", "zamba2"])
def test_counted_collectives_equal_the_real_step_s(arch, run):
    # the dry-run's count on meta tensors against the collectives the same
    # training step issues with data, by mesh dim, kind, calls and bytes:
    # llama's K/V heads stay whole on the model axis (GQA), grok's expert
    # weights and zamba2's A and D are read by every data rank, zamba2's B
    # and C by every head rank; their gradients come back as pending sums
    # that the step settles
    got, _ = run
    real, counted = got[f"{arch}_collectives"]
    assert counted == real
    assert {"all-reduce", "reduce-scatter"} & set(counted["data"])
    assert {"all-reduce", "reduce-scatter"} & set(counted["model"])


@pytest.mark.parametrize("wrapper", [
    "decode_attention", "prefill_attention", "prefill_attention_fwd", "prefill_attention_bwd",
    "ssd", "ssd_fwd", "ssd_bwd"])
def test_kernel_wrappers_refuse_a_dtensor(wrapper, run):
    got, _ = run
    assert "is a DTensor" in got["refusals"][wrapper]


def test_vocab_split_embedding_lookup_and_its_gradient(run):
    got, _ = run
    assert got["vocab_lookup_err"] == 0.0
    assert got["vocab_grad_err"] <= 1e-6
    # each data rank's rows give part of the table's gradient: a sum pending
    # over the data axis (train_step's grad_shardings settle it), its own
    # vocab rows on the model axis
    assert got["vocab_grad_placements"] == ["Partial(sum)", "Shard(dim=0)"]


def test_moe_prefill_and_train_step_through_the_expert_route(run):
    got, ref = run
    np.testing.assert_allclose(np.asarray(got["grok_logits"]), ref["grok_logits"],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert abs(got["grok_loss"][0] - got["grok_loss"][1]) <= LOSS_TOL
    bad = {k: e for k, e in got["grok_leaf_rel"].items() if not e <= LEAF_REL}
    assert not bad


def test_zamba2_prefill_through_the_ssd_route_matches_jax(run):
    got, ref = run
    np.testing.assert_allclose(np.asarray(got["zamba2_logits"]), ref["zamba2_logits"],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_zamba2_with_two_groups_on_the_mesh_gives_the_jax_tokens(run):
    got, ref = run
    assert got["zamba2_g2_tokens"] == ref["zamba2_g2_tokens"]


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        _worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]), sys.argv[i + 3])
