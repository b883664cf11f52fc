"""The port's dry run (``launch.dryrun``, ``launch.step_cost``,
``launch.roofline``) against the JAX package, on the CPU.

* ``SHAPES`` and ``shape_applicable`` equal the reference's for every arch.
* ``active_params``, ``model_flops`` and the rule table's per-device
  parameter bytes under (16, 16) and (2, 16, 16), with and without FSDP,
  equal the reference's on all ten full configs.  The reference's
  ``launch/dryrun.py`` forces 512 host devices when it is imported, so it
  runs in a subprocess, started when this module's tests start; its bytes
  are ``NamedSharding(...).shard_shape`` over its ``eval_shape`` params.
* The counted FLOPs of a reduced config's forward (the prefill step) and
  train step equal ``repro.launch.hlo_cost.analyze`` of the reference's same
  step compiled on one CPU device, within ``FLOPS_RTOL``; a failure names
  the port's FLOPs by op.
* ``tests/test_hlo_cost.py``'s properties on the port's counts: FLOPs linear
  in ``n_layers``; the train-to-forward ratio within [2.2, 3.8] at
  ``remat="none"``; elementwise ops 0 FLOPs with bytes >= read + write; a
  decode step's in-place cache write charged for its row, not the cache,
  and its bytes no fewer than the parameters and the cache read once.
* A fake key draws nothing; cells of each kind run (each says it counted
  the plain path), the roofline table reads them, and ``--all``'s process
  pool writes a cell and ends with the reference's summary line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_arch
from repro.configs.base import shape_applicable as ref_applicable
from repro.launch import hlo_cost
from repro.launch import steps as rsteps
from repro.models import api as rapi
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as radamw_init
from repro_torch import prng, tree
from repro_torch.configs import SHAPES, ShapeSpec, get_arch, list_archs
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import dryrun, step_cost
from repro_torch.launch.roofline import all_reduce_wire

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 1e-9  # both count 2 * M * N * K for every matmul: equal in fact
PARITY_ARCH = "yi-6b"  # reduced: 2 attn layers, GQA 4 over 2 heads
B, S = 2, 64

REF_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun  # forces 512 host devices before jax starts
    import jax
    import numpy as np
    from repro.configs import SHAPES, get_arch, list_archs
    from repro.launch.mesh import make_production_mesh
    from repro.parallel import sharding

    meshes = {k: make_production_mesh(multi_pod=(k == "multi")) for k in ("single", "multi")}
    out = {}
    for arch in list_archs():
        cfg = get_arch(arch)
        specs = dryrun.param_specs(cfg)
        n_active = dryrun.active_params(cfg)
        rec = {"active": n_active, "model_flops": {}, "bytes": {}}
        for kind, mesh in meshes.items():
            chips = int(np.prod(mesh.devices.shape))
            for name, shape in SHAPES.items():
                rec["model_flops"][f"{name}/{kind}"] = dryrun.model_flops(cfg, shape, n_active,
                                                                          chips)
            for fsdp in (False, True):
                shs = sharding.param_shardings(specs, mesh, fsdp=fsdp)
                rec["bytes"][f"{kind}/{fsdp}"] = sum(
                    int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
                    for l, s in zip(jax.tree.leaves(specs), jax.tree.leaves(shs)))
        out[arch] = rec
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's dry-run numbers from a subprocess started before the
    first test (it runs beside them); ``reference()`` waits for it."""
    path = tmp_path_factory.mktemp("ref") / "dryrun.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cache = {}

    def result() -> dict:
        if "out" not in cache:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            cache["out"] = json.loads(path.read_text())
        return cache["out"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# ---------------------------------------------------------------------------
# Shapes, parameter counts, per-device bytes
# ---------------------------------------------------------------------------

def test_shapes_and_applicability_equal_reference():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(REF_SHAPES[name])
    for arch in list_archs():
        for name in SHAPES:
            assert shape_applicable(get_arch(arch), SHAPES[name]) == ref_applicable(
                ref_arch(arch), REF_SHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_params_flops_and_device_bytes_equal_reference(arch, reference):
    cfg = get_arch(arch)
    mode = FakeTensorMode()
    params = dryrun.param_specs(cfg, mode)
    n_active = dryrun.active_params(cfg, params)
    want = reference()[arch]
    assert n_active == want["active"]
    for kind in dryrun.MESHES:
        mesh = dryrun.production_mesh(kind)
        chips = int(np.prod(mesh.sizes))
        for name, shape in SHAPES.items():
            assert dryrun.model_flops(cfg, shape, n_active, chips) == want["model_flops"][
                f"{name}/{kind}"], (name, kind)
        for fsdp in (False, True):
            got = dryrun.per_device_param_bytes(params, mesh, fsdp=fsdp)
            assert got == want["bytes"][f"{kind}/{fsdp}"], (kind, fsdp)


# ---------------------------------------------------------------------------
# FLOPs against the reference's hlo_cost, and hlo_cost's properties
# ---------------------------------------------------------------------------

def _port_cost(cfg, kind: str, *, rows: int = B, seq: int = S, remat: str = "none"):
    mode = FakeTensorMode()
    shape = ShapeSpec("t", seq, rows, kind)
    fn, args = dryrun.step_args(cfg, shape, dryrun.input_specs(cfg, shape, mode), remat=remat)
    with mode:
        return step_cost.count_step(fn, *args)[1]


@pytest.fixture(scope="module")
def parity_counts():
    rc = ref_arch(PARITY_ARCH, reduced=True)
    p = jax.eval_shape(lambda k: rapi.init(k, rc), jax.ShapeDtypeStruct((2,), jnp.uint32))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    fwd = jax.jit(rsteps.make_prefill_step(rc)).lower(p, batch).compile()
    opt = jax.eval_shape(radamw_init, p)
    train = jax.jit(rsteps.make_train_step(rc, RAdamWConfig(), remat="none")).lower(
        p, opt, batch).compile()
    cfg = get_arch(PARITY_ARCH, reduced=True)
    return {"ref_fwd": hlo_cost.analyze(fwd.as_text()).flops,
            "ref_train": hlo_cost.analyze(train.as_text()).flops,
            "fwd": _port_cost(cfg, "prefill"), "train": _port_cost(cfg, "train")}


@pytest.mark.parametrize("step", ["fwd", "train"])
def test_flops_equal_hlo_cost(parity_counts, step):
    got, want = parity_counts[step].flops, parity_counts[f"ref_{step}"]
    assert abs(got - want) <= FLOPS_RTOL * want, (
        f"{step}: port {got:.6g} vs hlo_cost {want:.6g}; the port's FLOPs by op: "
        f"{parity_counts[step].flops_by_op}")


def test_train_to_forward_ratio(parity_counts):
    ratio = parity_counts["train"].flops / parity_counts["fwd"].flops
    assert 2.2 <= ratio <= 3.8


def test_flops_linear_in_layers():
    base = get_arch(PARITY_ARCH, reduced=True)
    f = {n: _port_cost(dataclasses.replace(base, n_layers=n), "prefill").flops
         for n in (1, 2, 4)}
    assert f[4] - f[2] == 2 * (f[2] - f[1]) > 0


def test_elementwise_zero_flops_and_read_write_bytes():
    mode = FakeTensorMode()
    with mode:
        x = torch.empty(128, 128)
        _, c = step_cost.count_step(lambda a: torch.tanh(a) + 1.0, x)
    assert c.flops == 0.0
    assert c.bytes_accessed >= 2 * x.nbytes


def test_memory_tracker_failure_is_recorded(monkeypatch):
    from torch.distributed._tools import mem_tracker

    def broken(self, *a):
        raise RuntimeError("no tracking here")

    monkeypatch.setattr(mem_tracker.MemTracker, "track_external", broken)
    cfg = get_arch(PARITY_ARCH, reduced=True)
    c = _port_cost(cfg, "decode", seq=128)
    assert c.peak_bytes is None and c.memory_error == "RuntimeError: no tracking here"
    assert c.flops > 0 and c.bytes_accessed > 0
    r = dryrun.run_cell(PARITY_ARCH, "decode_32k", "single", cfg=cfg)
    assert r["status"] == "ok" and r["memory_analysis"] == {}
    assert r["memory_error"] == "RuntimeError: no tracking here"


def test_decode_charges_the_cache_row_not_the_cache():
    cfg = get_arch(PARITY_ARCH, reduced=True)
    c1, c2 = (_port_cost(cfg, "decode", seq=s) for s in (1024, 2048))
    writes = c2.bytes_by_op["aten.index_copy_"]
    row = 2 * cfg.n_layers * B * cfg.n_kv_heads * cfg.resolved_head_dim * 4  # k, v rows, f32
    assert writes <= 4 * row  # read the row, write it, its index: nothing of the cache
    cache_delta = c2.argument_bytes - c1.argument_bytes  # params equal; the cache doubled
    # the attention reads the cache once (f32: no cast) and its scores add ~1/2
    # (measured 1.54x); an in-place write charged whole would add 2x more
    assert c2.bytes_accessed - c1.bytes_accessed < 2 * cache_delta


@pytest.mark.parametrize("seq", [16, 1024])  # the parameters' bytes lead, then the cache's
@pytest.mark.parametrize("arch", ["yi-6b", "gemma-2b"])  # an untied and a tied head
def test_decode_bytes_cover_the_params_and_the_cache(arch, seq):
    """A floor that a missing charge fails: a decode step reads every
    parameter once (an untied embedding table only by the rows it gathers)
    and the whole cache; its Q.K and P.V batched matmuls read the cache in
    float32 and write, then read, the scores."""
    cfg = get_arch(arch, reduced=True)
    mode = FakeTensorMode()
    shape = ShapeSpec("t", seq, B, "decode")
    inputs = dryrun.input_specs(cfg, shape, mode)
    fn, args = dryrun.step_args(cfg, shape, inputs)
    with mode:
        c = step_cost.count_step(fn, *args)[1]
    params, cache = inputs["params"], tree.leaves(inputs["cache"])
    embed = 0 if cfg.tie_embeddings else step_cost.storage_bytes(
        tree.leaves(params["embed"]))
    floor = (step_cost.storage_bytes(tree.leaves(params)) - embed
             + step_cost.storage_bytes(cache))
    assert c.bytes_accessed >= floor
    scores = 4 * cfg.n_layers * B * cfg.n_heads * seq
    assert c.bytes_by_op["aten.bmm"] >= 4 * sum(t.numel() for t in cache) + 2 * scores


def test_partial_writes_and_gathers_count_what_they_touch():
    aten = torch.ops.aten
    big = torch.zeros(4, 1000, 8)
    src = torch.ones(4, 2, 8)
    idx = torch.tensor([3, 7])
    assert step_cost.op_bytes(aten.index_copy_.default, (big, 1, idx, src), {}, big) == (
        idx.nbytes + 2 * src.nbytes)
    table = torch.zeros(50000, 64)
    ids = torch.tensor([[1, 2, 3]])
    out = torch.nn.functional.embedding(ids, table)
    assert step_cost.op_bytes(aten.embedding.default, (table, ids), {}, out) == (
        ids.nbytes + 2 * out.nbytes)
    view = big[:, 5]
    assert step_cost.op_bytes(aten.copy_.default, (view, src[:, 0]), {}, view) == (
        2 * src[:, 0].nbytes)
    assert step_cost.op_bytes(aten.slice.Tensor, (big, 1, 0, 10), {}, big[:, :10]) == 0


# ---------------------------------------------------------------------------
# The fake-mode prng, the cells, the gates and the roofline table
# ---------------------------------------------------------------------------

def test_fake_key_draws_nothing():
    shape = (1 << 15, 1 << 15)  # 2^30 elements: hours of threefry, 4 GiB if drawn
    with FakeTensorMode():
        key = prng.PRNGKey(0)
        t0 = time.perf_counter()
        draws = [prng.normal(key, shape), prng.truncated_normal(key, -2.0, 2.0, shape),
                 prng.uniform(key, shape), prng.randint(key, shape, 0, 7)]
        took = time.perf_counter() - t0
    for x in draws:
        assert isinstance(x, FakeTensor) and tuple(x.shape) == shape
    assert draws[3].dtype == torch.int32 and took < 5.0
    meta = prng.normal(torch.zeros(2, dtype=torch.int64, device="meta"), (3, 5))
    assert meta.device.type == "meta" and tuple(meta.shape) == (3, 5)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    cfg = get_arch(PARITY_ARCH, reduced=True)
    got = {s: dryrun.run_cell(PARITY_ARCH, s, "single", cfg=cfg, out_dir=out)
           for s in ("train_4k", "decode_32k", "long_500k")}
    moe = get_arch("qwen2-moe-a2.7b", reduced=True)
    moe = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe, pad_experts_to=16))
    got["moe"] = dryrun.run_cell("qwen2-moe-a2.7b", "decode_32k", "multi", cfg=moe,
                                 moe_sharded=True, out_dir=out)
    return out, got


def test_cells_record_the_reference_keys(cells):
    out, got = cells
    train, decode = got["train_4k"], got["decode_32k"]
    for r in (train, decode):
        assert r["status"] == "ok", r.get("error")
        assert {"chips", "lower_s", "n_active_params", "memory_analysis", "collectives",
                "roofline", "no_counterpart"} <= set(r)
        assert set(r["memory_analysis"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                             "peak_bytes"}
        assert r["memory_analysis"]["peak_bytes"] >= r["memory_analysis"]["argument_bytes"]
        assert r["counted_path"] == "plain"
    assert got["long_500k"] == json.loads((out / f"{PARITY_ARCH}_long_500k_single.json")
                                          .read_text())
    assert got["long_500k"]["status"] == "skipped"
    assert train["device"]["rows"] == 256 // 16 and decode["device"]["rows"] == 128 // 16
    # the data-parallel gradient all-reduce over the 16 data shards: f32
    # gradients of the device's TP shard of the params
    grad = train["device"]["layout"]["param_bytes_tp"]
    assert train["collectives"]["wire_by_axis"]["data"] == all_reduce_wire(grad, 16)


def test_moe_sharded_cell_reduces_at_the_gate(cells):
    _, got = cells
    r = got["moe"]
    assert r["status"] == "ok", r.get("error")
    n_layers = get_arch("qwen2-moe-a2.7b", reduced=True).n_layers
    assert r["collectives"]["count"]["all-reduce"] == n_layers  # one psum a MoE layer
    assert r["device"]["rows"] == 128 // 32
    assert r["device"]["tp"]["reasons"]["attn"].startswith("block kinds")


def test_swa_banded_names_the_departure():
    with pytest.raises(ValueError, match="A.16.2"):
        dryrun.run_cell(PARITY_ARCH, "decode_32k", "single", swa_banded=True)


def test_roofline_table_reads_the_cells(cells):
    from benchmarks_torch import roofline

    out, got = cells
    res = roofline.run(dryrun_dir=out)
    assert {(r["shape"], r["arch"]) for r in res["rows"]} == {
        ("train_4k", PARITY_ARCH), ("decode_32k", PARITY_ARCH),
        ("decode_32k", "qwen2-moe-a2.7b")}
    row = next(r for r in res["rows"] if r["shape"] == "decode_32k" and r["arch"] == PARITY_ARCH)
    assert row["memory_s"] == got["decode_32k"]["roofline"]["memory_s"]
    assert row["bottleneck"] == "memory"


def test_all_runs_the_cells_in_a_pool(tmp_path):
    """The CLI's pool on two cells the reference skips (yi-6b is not
    sub-quadratic): one JSON a cell and the summary line."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", PARITY_ARCH, "--shape",
         "long_500k", "--mesh", "both", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.splitlines()[-1] == "done: 0 ok, 2 skipped, 0 errors"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"{PARITY_ARCH}_long_500k_{m}.json" for m in ("multi", "single")]
