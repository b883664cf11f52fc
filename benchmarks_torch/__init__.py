"""The paper's figures on the PyTorch/CUDA port (``repro_torch``).

Counterparts of ``benchmarks/fig5_sws_single.py`` … ``fig10_columns.py``
(both halves of fig9 and fig10), ``trained_lm.py``, ``accuracy_e2e.py`` and
``benchmarks/planner_throughput.py``, with the reference's ``run``
signatures and printed summaries plus ``--device``.
They import ``torch`` and ``repro_torch``, never ``jax``, ``repro`` or
``benchmarks``, and write their JSON to ``experiments/bench_torch/``.
``golden/reference.json`` holds the reference's integers at a recorded size
and its trained LM's accuracies and predictions, ``golden/trained_lm_seed0.npz``
its trained weights (``tools/reference_figures.py`` writes both);
``chip_smoke.py`` holds the card's results to them.
"""
