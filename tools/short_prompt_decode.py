"""Decode after a short prompt against ``forward``, in the reference and the port.

The reduced xlstm-350m (float32, conv width 4) from ``PRNGKey(0)``, batch
2, tokens from numpy seed 0: a prefill of each prompt length, its cache
merged into a zero cache, then three teacher-forced decode steps.  For each
step the script prints ``max |decode - forward|`` at that position, for the
reference (``repro``, jitted on the CPU) and for the port
(``repro_torch``, on the CPU, the reference's weights).  A prompt shorter
than ``conv_width - 1`` shows ROADMAP C.13: the reference's conv tail is
shorter than the conv state and its merge writes it first.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/short_prompt_decode.py [--prompts 1,2,6]

Imports JAX and the reference package on purpose (a CPU tool, like
``tools/reference_figures.py``).
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jget
from repro.models import api as japi
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.models import api

ARCH, BATCH, STEPS = "xlstm-350m", 2, 3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", default="1,2,6")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    jcfg, cfg = jget(ARCH, reduced=True), get_arch(ARCH, reduced=True)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    jdecode = jax.jit(lambda p, c, t, pos: japi.decode_step(p, jcfg, c, t, pos))
    for prompt in (int(p) for p in args.prompts.split(",")):
        total = prompt + STEPS + 1
        tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, total))
        tok = tok.astype(np.int32)
        jfull = np.asarray(japi.forward(jp, jcfg, {"tokens": jnp.asarray(tok)})[0])
        _, jpf = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(tok[:, :prompt])})
        jcache = japi.merge_prefill_cache(jcfg, japi.init_cache(jcfg, BATCH, total), jpf)
        t = torch.from_numpy(tok).long()
        full, _ = api.forward(tp, cfg, {"tokens": t})
        _, pf = api.prefill(tp, cfg, {"tokens": t[:, :prompt]})
        cache = api.merge_prefill_cache(cfg, api.init_cache(cfg, BATCH, total, device="cpu"),
                                        pf)
        ref, port = [], []
        for i in range(prompt, prompt + STEPS):
            jl, jcache = jdecode(jp, jcache, jnp.asarray(tok[:, i:i + 1]), jnp.int32(i))
            tl, cache = api.decode_step(tp, cfg, cache, t[:, i:i + 1], torch.tensor(i))
            ref.append(float(np.abs(np.asarray(jl)[:, 0] - jfull[:, i]).max()))
            port.append(float((tl[:, 0] - full[:, i]).abs().max()))
        print(f"prompt {prompt}: max |decode - forward| at positions {prompt}..{prompt + STEPS - 1}"
              f": reference " + " ".join(f"{v:.3g}" for v in ref)
              + "; port " + " ".join(f"{v:.3g}" for v in port))


if __name__ == "__main__":
    main()
