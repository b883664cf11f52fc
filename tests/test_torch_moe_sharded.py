"""The sharded MoE dispatch on the port against the JAX package, on the CPU.

The reference's ``set_moe_distribution(mesh)`` sends ``moe_mlp`` through a
``shard_map``: tokens split over the data axes with a capacity per data
shard, experts over "model" (expert-parallel when ``n_alloc`` divides it,
expert-TP on ``d_expert`` otherwise), one psum.  Its tests keep the
in-process jax at one device, so one module-scoped subprocess runs the
reference on six forced host devices (meshes with ``AxisType.Auto`` axes,
without which ``jax.grad`` through the dispatch raises) and writes its
params and sharded outputs to an ``.npz``; the port runs in process from
those params converted.

Cases: reduced qwen2-moe-a2.7b at (data 2, model 2) and (1, 4), both EP
(n_alloc 8), and (2, 3), expert-TP (8 % 3 != 0, d_expert 96 / 3); reduced
deepseek-v2-236b (``mla_moe``) at (2, 3), expert-TP.  Tolerances:
``moe_mlp``, the forward logits and aux and every gradient leaf of the
train loss within 1e-5 of the largest magnitude (float32 partials summed in
another order); served greedy tokens identical.  The capacity binds in
these cases, so the sharded outputs differ from the unsharded ones by far
more than that (the port's own departure is held below).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import serve, steps
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh
from repro_torch.models import api, moe
from repro_torch.parallel import collective

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
GEN = 6
ARCHS = {"qwen": "qwen2-moe-a2.7b", "dsv2": "deepseek-v2-236b"}
CASES = {  # name: (arch, (data, model)), the reference's layout of each
    "qwen-2x2": ("qwen", (2, 2)),  # EP: 4 of the 8 experts a shard
    "qwen-1x4": ("qwen", (1, 4)),  # EP: 2 a shard
    "qwen-2x3": ("qwen", (2, 3)),  # expert-TP: d_expert 96 -> 32 a shard
    "dsv2-2x3": ("dsv2", (2, 3)),  # expert-TP: d_expert 48 -> 16 a shard
}

REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.launch import serve, steps
    from repro.models import api, moe

    inputs, cases, arch, gen = pickle.load(open(sys.argv[1], "rb"))
    cfg = get_arch(arch, reduced=True)
    p = jax.jit(api.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    out = {"params": jax.tree.map(np.asarray, p)}
    batch = {"tokens": jnp.asarray(inputs["tokens"])}

    for name, shape in cases.items():
        n = shape[0] * shape[1]
        mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,) * 2)
        moe.set_moe_distribution(mesh)

        # a new function a mesh: jit's cache does not see the registered mesh
        def outputs(p, x):
            layer0 = jax.tree.map(lambda a: a[0], p["segments"][0]["moe"])
            y, aux = moe.moe_mlp(layer0, cfg, x)
            logits, faux = api.forward(p, cfg, batch)
            (loss, _), grads = jax.value_and_grad(
                lambda q: steps.loss_fn(q, cfg, batch), has_aux=True)(p)
            return y, aux, logits, faux, loss, grads

        y, aux, logits, faux, loss, grads = jax.jit(outputs)(p, jnp.asarray(inputs["x"]))
        toks, _ = serve.generate(cfg, p, {"tokens": jnp.asarray(inputs["prompt"])}, gen_len=gen)
        moe.set_moe_distribution(None)
        out[name] = {"moe_y": np.asarray(y), "moe_aux": np.asarray(aux),
                     "logits": np.asarray(logits), "aux": np.asarray(faux),
                     "loss": np.asarray(loss), "grads": jax.tree.map(np.asarray, grads),
                     "tokens": np.asarray(toks)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _unsharded_after():
    yield
    moe.set_moe_distribution(None)


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((4, 8, 64)).astype(np.float32),
            "tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
            "prompt": rng.integers(0, 256, (4, 8)).astype(np.int32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's params and sharded outputs: one subprocess an arch,
    run side by side (jitted: the eager shard_map takes ~20 s a call)."""
    d = tmp_path_factory.mktemp("moe_sharded")
    (d / "ref.py").write_text(REF_SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    env.pop("XLA_FLAGS", None)
    procs = {}
    for tag, arch in ARCHS.items():
        with open(d / f"{tag}.in", "wb") as f:
            pickle.dump((_inputs(), {k: v[1] for k, v in CASES.items() if v[0] == tag}, arch,
                         GEN), f)
        procs[tag] = subprocess.Popen(
            [sys.executable, str(d / "ref.py"), str(d / f"{tag}.in"), str(d / f"{tag}.out")],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        errs = {tag: p.communicate(timeout=600)[1] for tag, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    out = {}
    for tag, p in procs.items():
        assert p.returncode == 0, errs[tag][-4000:]
        with open(d / f"{tag}.out", "rb") as f:
            got = pickle.load(f)
        out[f"{tag}/params"] = got.pop("params")
        out.update(got)
    out["cfg"] = {tag: get_arch(arch, reduced=True) for tag, arch in ARCHS.items()}
    out["tparams"] = {tag: from_numpy_tree(out[f"{tag}/params"], device="cpu") for tag in ARCHS}
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    d = float(np.abs(got.detach().numpy() - want).max())
    assert d <= TOL * scale, f"{what}: max |d| {d:.3e} > {TOL:g} * {scale:.3e}"


def _register(case: str) -> None:
    moe.set_moe_distribution(make_mesh(CASES[case][1], ("data", "model")))


def _layer0(params):
    return tree.tree_map(lambda a: a[0], params["segments"][0]["moe"])


@pytest.mark.parametrize("case", list(CASES))
def test_moe_mlp_matches_reference(ref, case):
    tag = CASES[case][0]
    _register(case)
    y, aux = moe.moe_mlp(_layer0(ref["tparams"][tag]), ref["cfg"][tag], _t(_inputs()["x"]))
    _close(y, ref[case]["moe_y"], f"{case} moe_mlp")
    _close(aux, ref[case]["moe_aux"], f"{case} aux")


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_grads_match_reference(ref, case):
    tag = CASES[case][0]
    cfg, params = ref["cfg"][tag], ref["tparams"][tag]
    batch = {"tokens": _t(_inputs()["tokens"]).long()}
    _register(case)
    with torch.no_grad():
        logits, aux = api.forward(params, cfg, batch)
    _close(logits, ref[case]["logits"], f"{case} logits")
    _close(aux, ref[case]["aux"], f"{case} aux")
    p = tree.tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, _ = steps.loss_fn(p, cfg, batch)
    paths = [path for path, _ in tree.leaves_with_path(p)]
    grads = torch.autograd.grad(loss, [leaf for _, leaf in tree.leaves_with_path(p)])
    _close(loss, ref[case]["loss"], f"{case} loss")
    want = dict((tree.path_name(path), leaf) for path, leaf in
                tree.leaves_with_path(from_numpy_tree(ref[case]["grads"], device="cpu")))
    assert sorted(want) == sorted(tree.path_name(q) for q in paths)
    for path, g in zip(paths, grads):
        _close(g, want[tree.path_name(path)].numpy(), f"{case} grad {tree.path_name(path)}")


@pytest.mark.parametrize("case", list(CASES))
def test_generate_tokens_match_reference(ref, case):
    tag = CASES[case][0]
    _register(case)
    got, _ = serve.generate(ref["cfg"][tag], ref["tparams"][tag],
                            {"tokens": _t(_inputs()["prompt"]).long()}, gen_len=GEN)
    np.testing.assert_array_equal(got.numpy(), ref[case]["tokens"])


@pytest.mark.parametrize("case", ["qwen-2x2", "dsv2-2x3"])
def test_capacity_per_data_shard_departs_and_none_restores(ref, case):
    """With the capacity binding, the sharded logits depart from the
    unsharded ones by far more than the tolerance; ``set_moe_distribution
    (None)`` gives the unsharded bytes back."""
    tag = CASES[case][0]
    cfg, params = ref["cfg"][tag], ref["tparams"][tag]
    batch = {"tokens": _t(_inputs()["tokens"]).long()}
    with torch.no_grad():
        plain, _ = api.forward(params, cfg, batch)
        _register(case)
        sharded, _ = api.forward(params, cfg, batch)
        moe.set_moe_distribution(None)
        again, _ = api.forward(params, cfg, batch)
    assert float((sharded - plain).abs().max()) > 100 * TOL * float(plain.abs().max())
    assert torch.equal(again, plain)


def test_one_data_shard_row_equals_the_unsharded_forward_of_its_rows(ref):
    """The data shards are row-independent but for the capacity: at (2, 4)
    each half of the batch gives what the unsharded forward of that half
    gives (the chip check's gate, here at the reduced size)."""
    cfg, params = ref["cfg"]["qwen"], ref["tparams"]["qwen"]
    tokens = _t(_inputs()["tokens"]).long()
    with torch.no_grad():
        halves = [api.forward(params, cfg, {"tokens": tokens[i:i + 2]})[0] for i in (0, 2)]
        moe.set_moe_distribution(make_mesh((2, 4), ("data", "model")))
        sharded, _ = api.forward(params, cfg, {"tokens": tokens})
    want = torch.cat(halves)
    assert float((sharded - want).abs().max()) <= TOL * float(want.abs().max())


def test_refusals(ref):
    cfg, params = ref["cfg"]["qwen"], ref["tparams"]["qwen"]
    tokens = {"tokens": _t(_inputs()["tokens"]).long()}
    # operand dicts: packed and planes_int8 deployments under a mesh, as the
    # reference's shard_map refuses them (ROADMAP C.15)
    plan = planner.build_deployment(params, planner.CrossbarSpec(),
                                    planner.PlannerConfig(min_size=1024), device="cpu")
    moe.set_moe_distribution(make_mesh((2, 2), ("data", "model")))
    for materialize in ("packed", "planes_int8"):
        deployed = planner.deploy_params(params, plan, materialize=materialize)
        with pytest.raises(ValueError, match="operand dicts"):
            api.forward(deployed, cfg, tokens)
    api.forward(planner.deploy_params(params, plan, materialize="dense"), cfg, tokens)
    # a batch that does not split over the data shards
    with pytest.raises(ValueError, match="batch 3 does not split"):
        api.forward(params, cfg, {"tokens": tokens["tokens"][:3]})
    # neither n_alloc 8 nor d_expert 96 over 5
    moe.set_moe_distribution(make_mesh((1, 5), ("data", "model")))
    with pytest.raises(ValueError, match="neither n_alloc 8"):
        api.forward(params, cfg, tokens)
    # EP over 8 with a shared width of 36 that does not divide
    small = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, d_expert=36, n_shared=1))
    p_small = moe.init_moe_mlp(prng.PRNGKey(1), small)
    moe.set_moe_distribution(make_mesh((1, 8), ("data", "model")))
    with pytest.raises(ValueError, match="shared width 36"):
        moe.moe_mlp(p_small, small, torch.zeros(2, 3, cfg.d_model))
    with pytest.raises(ValueError, match="no model axis"):
        moe.set_moe_distribution(make_mesh((2,), ("data",)))
    with pytest.raises(ValueError):
        Mesh(("data", "data"), (1, 1))


def test_meshes_and_the_registered_distribution():
    import jax

    assert make_host_mesh().shape == {"data": 1, "model": 1}
    assert moe.distribution() is None
    # a jax mesh serves as well as the port's own
    moe.set_moe_distribution(jax.make_mesh((1, 1), ("data", "model")))
    assert moe.distribution() == ((("data", 1), ("model", 1)), "model")
    moe.set_moe_distribution(make_mesh((2, 1, 4), ("pod", "data", "model")))
    assert moe.distribution() == ((("pod", 2), ("data", 1), ("model", 4)), "model")
    assert moe._DIST["data_axes"] == ("pod", "data")
    moe.set_moe_distribution(None)
    assert moe.distribution() is None


def test_a_generator_is_bound_to_its_distribution(ref):
    """A generator built unsharded refuses to run under a mesh and the
    other way round: its decode graph holds the other dispatch."""
    cfg, params = ref["cfg"]["qwen"], ref["tparams"]["qwen"]
    batch = {"tokens": _t(_inputs()["prompt"]).long()}
    run = serve.make_generator(cfg, params, batch, gen_len=3)
    _register("qwen-2x2")
    with pytest.raises(RuntimeError, match="MoE distribution"):
        run()
    run_sharded = serve.make_generator(cfg, params, batch, gen_len=3)
    run_sharded()
    moe.set_moe_distribution(None)
    with pytest.raises(RuntimeError, match="MoE distribution"):
        run_sharded()
    run()


# ---------------------------------------------------------------------------
# one model shard a rank: the torch.distributed gate
# ---------------------------------------------------------------------------

RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, moe
    from repro_torch.parallel import collective

    torch.set_num_threads(1)
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 256, (4, 12)).astype(np.int64))
    res = {}
    for name, pad in (("ep", None), ("tp", 9)):
        cfg = get_arch("qwen2-moe-a2.7b", reduced=True)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, pad_experts_to=pad))
        params = api.init(prng.PRNGKey(0), cfg, device="cpu")
        moe.set_moe_distribution(make_mesh((2, 2), ("data", "model")))
        with collective.active(collective.ProcessGroupGate()), torch.no_grad():
            res[name + "_logits"] = api.forward(params, cfg, {"tokens": tokens})[0].numpy()
            res[name + "_tokens"] = serve.generate(cfg, params, {"tokens": tokens[:, :8]},
                                                   gen_len=4)[0].numpy()
    # two ranks cannot hold the four shards of a (1, 4) mesh one a rank
    moe.set_moe_distribution(make_mesh((1, 4), ("data", "model")))
    with collective.active(collective.ProcessGroupGate()), torch.no_grad():
        try:
            api.forward(params, cfg, {"tokens": tokens})
        except ValueError as e:
            res["mismatch"] = np.array(str(e))
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_process_group_gate_matches_the_shard_loop(tmp_path):
    """Two gloo ranks, each one model shard of a (data 2, model 2) mesh (the
    gate's rank) with both data shards in process: EP (n_alloc 8) and
    expert-TP (n_alloc 9, d_expert 96 / 2) give the ShardLoop's logits and
    tokens; a (1, 4) mesh over the two ranks raises."""
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    out = tmp_path / "out.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    got = np.load(out)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 12)).astype(np.int64))
    for name, pad in (("ep", None), ("tp", 9)):
        cfg = get_arch("qwen2-moe-a2.7b", reduced=True)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, pad_experts_to=pad))
        assert (cfg.moe.n_alloc % 2 == 0) == (name == "ep")
        params = api.init(prng.PRNGKey(0), cfg, device="cpu")
        moe.set_moe_distribution(make_mesh((2, 2), ("data", "model")))
        with collective.active(collective.ShardLoop()), torch.no_grad():
            logits = api.forward(params, cfg, {"tokens": tokens})[0]
            toks = serve.generate(cfg, params, {"tokens": tokens[:, :8]}, gen_len=4)[0]
        np.testing.assert_array_equal(got[name + "_logits"], logits.numpy())
        np.testing.assert_array_equal(got[name + "_tokens"], toks.numpy())
    assert "2-rank process group cannot hold the 4 shards" in str(got["mismatch"])
