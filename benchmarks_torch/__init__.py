"""The paper's planner figures on the PyTorch/CUDA port (``repro_torch``).

Counterparts of ``benchmarks/fig5_sws_single.py`` … ``fig10_columns.py``
(their transition halves) and ``benchmarks/planner_throughput.py``, with
the reference's ``run`` signatures and printed summaries plus ``--device``.
They import ``torch`` and ``repro_torch``, never ``jax``, ``repro`` or
``benchmarks``, and write their JSON to ``experiments/bench_torch/``.
``golden/reference.json`` holds the reference's integers at a recorded size
(``tools/reference_figures.py`` writes it); ``chip_smoke.py`` holds the
card's results to it.
"""
