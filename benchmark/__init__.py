"""The benchmark of ``gennet_tpu_torch`` on one NVIDIA H100: the production
recipes' GAN and PE training loops as replayed chunks. ``run.py`` runs one
cell of ``BENCHMARK.json``; see ``PERF.md`` at the repository root."""
