"""Pool wear on the port: persistent crossbar pool + wear-leveling assignment.

The port's copy of ``benchmarks/pool_wear.py``.  Streams a sequence of model
deployments (checkpoints of the reduced gemma-2b architecture, drifting
between deployments) through ONE persistent ``CrossbarPool`` per leveling
policy and reports physical per-cell wear: max/mean cell writes,
per-crossbar imbalance, and the endurance-budget exhaustion horizon.  The
headline number is how much the LPT chain->crossbar assignment reduces
*max-cell* wear against the identity assignment.

The weights and drift are the reference's draws (``api.init`` and
``prng.normal`` bit for bit), except the drift's scale ``jnp.std(w)``:
XLA:CPU sums in an order that torch's reductions do not reproduce, so the
port's own std can differ from the reference's in the last bit.  ``run(stds=...)``
takes the reference's values (``golden/reference.json``'s ``pool_wear``
entry records them) to drift with the reference's bits, as the tests and
``chip_smoke.py`` do; the command line uses the port's own std and prints
its largest gap to the golden values in float32 ulps.

  PYTHONPATH=src python -m benchmarks_torch.pool_wear [--deployments N] [--device cpu]

Writes experiments/bench_torch/BENCH_pool.json.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from benchmarks_torch.common import Timer, banner, save_json
from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.core.planner import CrossbarSpec, PlannerConfig, build_deployment
from repro_torch.core.pool import DEFAULT_ENDURANCE, LEVELINGS, CrossbarPool
from repro_torch.kernels._util import resolve_device
from repro_torch.models import api

ARCH = "gemma-2b"
DRIFT = 0.02  # relative weight drift between successive deployments
GOLDEN = Path(__file__).resolve().parent / "golden" / "reference.json"


def std(w: torch.Tensor) -> torch.Tensor:
    """``jnp.std``'s steps in float32: mean = sum / n, then the mean of the
    squared deviations, then sqrt (torch's summation order)."""
    n = torch.tensor(float(w.numel()), dtype=torch.float32, device=w.device)
    c = w - w.sum() / n
    return torch.sqrt((c * c).sum() / n)


def f32_hex(x: torch.Tensor) -> str:
    """The bits of a float32 scalar as 8 hex digits."""
    return f"{int(x.detach().cpu().reshape(1).view(torch.int32)) & 0xFFFFFFFF:08x}"


def _from_hex(h: str, device) -> torch.Tensor:
    bits = np.array([int(h, 16)], np.uint32).view(np.float32)
    return torch.from_numpy(bits).reshape(()).to(device)


def _checkpoints(n: int, seed: int, device, stds: list[dict] | None, used: list):
    """The same reduced-gemma param tree, drifting like training checkpoints.

    ``stds[d][name]`` (f32 hex) replaces the std of leaf ``name`` at drift
    step ``d``; ``used`` collects the std each step applied, as
    {name: hex} per step."""
    cfg = get_arch(ARCH, reduced=True)
    params = api.init(prng.PRNGKey(seed), cfg, device=device)
    key = prng.PRNGKey(seed + 1, device=device)
    drift = torch.tensor(DRIFT, dtype=torch.float32, device=device)
    for d in range(n):
        yield params
        key, sub = prng.split(key).unbind(-2)
        leaves = list(tree.leaves_with_path(params))
        step, out = {}, []
        for (path, w), k in zip(leaves, prng.split(sub, len(leaves))):
            if w.ndim < 2:
                out.append(w)
                continue
            name = tree.path_name(path)
            s = _from_hex(stds[d][name], device) if stds is not None else std(w)
            step[name] = f32_hex(s)
            out.append(w + drift * s * prng.normal(k, tuple(w.shape)))
        used.append(step)
        params = tree.unflatten(params, out)


def ulp_gap(a: str, b: str) -> int:
    """Distance in float32 ulps between two positive float32 bit patterns."""
    return abs(int(a, 16) - int(b, 16))


def run(*, deployments: int = 3, p_stuck: float = 0.5, seed: int = 0,
        stds: list[dict] | None = None, device=None) -> dict:
    """Each leveling streams ``deployments`` checkpoints through one pool on
    ``device`` (CUDA unless the caller asks for the CPU); ``stds`` as in
    :func:`_checkpoints`."""
    dev = resolve_device(device)
    spec = CrossbarSpec(rows=128, cols=10)
    results: dict[str, dict] = {}
    used: list = []
    for leveling in LEVELINGS:
        cfg = PlannerConfig(p_stuck=p_stuck, min_size=1024, pool_leveling=leveling)
        pool = CrossbarPool(spec, cfg.crossbars, leveling=leveling, device=dev)
        used.clear()
        with Timer(dev) as t:
            for params in _checkpoints(deployments, seed, dev, stds, used):
                build_deployment(params, spec, cfg, pool=pool, device=dev)
        stats = pool.stats()
        per_xbar = pool.wear_totals()
        results[leveling] = {
            **stats.to_dict(DEFAULT_ENDURANCE),
            # exhaustion_horizon counts repeats of the whole observed history
            # (here: `deployments` deployments); convert to deployments
            "exhaustion_horizon_deployments": stats.exhaustion_horizon(DEFAULT_ENDURANCE)
            * deployments,
            "crossbar_imbalance": float(per_xbar.max() / max(per_xbar.mean(), 1.0)),
            "seconds": t.seconds,
        }
    none_max = results["none"]["max_cell_writes"]
    lpt_max = results["lpt"]["max_cell_writes"]
    return {
        "arch": f"{ARCH} (reduced)",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "deployments": deployments,
        "drift": DRIFT,
        "p_stuck": p_stuck,
        "endurance": DEFAULT_ENDURANCE,
        "stds_from": "given" if stds is not None else "own",
        "stds": list(used),
        "levelings": results,
        "max_wear_reduction_lpt_vs_none": none_max / max(lpt_max, 1),
    }


def golden_stds(deployments: int) -> list[dict] | None:
    """The reference's drift stds from the golden file, if it holds as
    many deployments."""
    if not GOLDEN.exists():
        return None
    entry = json.loads(GOLDEN.read_text()).get("pool_wear")
    if not entry or len(entry["stds"]) < deployments:
        return None
    return entry["stds"][:deployments]


def std_gaps(own: list[dict], ref: list[dict]) -> int:
    """Largest ulp gap between two runs' stds over the steps both made."""
    return max((ulp_gap(a[k], b[k]) for a, b in zip(own, ref) for k in a), default=0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--deployments", type=int, default=3)
    ap.add_argument("--p-stuck", type=float, default=0.5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    banner("Pool wear — persistent crossbar pool + wear leveling")
    r = run(deployments=args.deployments, p_stuck=args.p_stuck, device=args.device)
    for lev, s in r["levelings"].items():
        print(
            f"  {lev:7s} max_cell={s['max_cell_writes']:8d}  "
            f"mean={s['mean_cell_writes']:8.1f}  imbalance={s['crossbar_imbalance']:.3f}  "
            f"horizon={s['exhaustion_horizon_deployments']:.3g} deployments"
        )
    print(f"  LPT leveling reduces max-cell wear {r['max_wear_reduction_lpt_vs_none']:.2f}x")
    ref = golden_stds(args.deployments)
    if ref is not None:
        print(f"  own std vs the reference's: largest gap {std_gaps(r['stds'], ref)} ulp")
    save_json("BENCH_pool", r)


if __name__ == "__main__":
    main()
