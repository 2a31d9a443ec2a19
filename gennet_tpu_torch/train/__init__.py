"""Training: CNN point-estimator and pair-GAN steps, the softmax, denoiser
and two-stage GAN trainers, data parallelism, checkpoints, metrics."""
