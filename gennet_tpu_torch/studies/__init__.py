"""The post-run studies (counterparts of the JAX package's offline
scripts in ``scripts/``, module for module): each re-scores or probes a
finished run directory of the port, without retraining.

============================  ===========================================
module                        what it measures
============================  ===========================================
``bbh_postproc_eval``         the post-processing routes and the library
                              selection on a flagship run's saved clouds
``elbo_stack_eval``           pools of the top-K ELBO clouds, rescored
``twin_cue_probe``            the event-twin cue of a ch1-only D
``d_memorization_probe``      the pair D on seven pair families
``bbh_sampler_calibration``   16 sampler settings on the final G and PE
``burst_pool_study``          the candidate library on burst runs
``burst_rescore_study``       truth-free scores against grid overlap
``burst_debias_diag``         the burst grid's geometry and the oracle
                              corrections, seeds 0-2
============================  ===========================================

Each holds its arithmetic as plain functions on tensors, which take the
random draws as arguments or from an explicit ``torch.Generator`` seeded
with the integers the JAX script gives its keys (the two streams differ),
and a ``main(argv)``::

    python -m gennet_tpu_torch.studies.<name> RUN_DIR [...] [--device cuda]

``--device`` defaults to ``cuda``, and the study runs on the kind of
device the run was made on (the run's event is drawn again from its
seed). Rows go, with the JAX script's keys in its order, to its file name
under ``out/torch/`` of the working directory (``out/torch/bbh_sweeps/``,
``out/torch/sweeps/``), beside the recipes' results.
"""
